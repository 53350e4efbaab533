"""Where the time goes inside the bf16 cosine top-k kernel, block by block.

    python3 -m cslam_tpu_torch.tools.knn_phase_times

Needs an NVIDIA card and nvcc. Builds a copy of csrc/cosine_topk.cu with
`%globaltimer` stamps at the phase boundaries of the tensor-core kernel
(the shipped kernel has none), loads it in place of the kernel library
for this process, runs one search per shape and prints one JSON line per
shape: the launch's span, and the median and largest per-block time of
each phase — query preparation (ticket, normalization or the wait for
it), the main loop with its tile epilogues and merges, the epilogues and
merges alone, publishing the lists — and the last blocks' final merges.
Raises if the kernel source no longer has the lines the stamps go after.
"""

import ctypes
import json
import statistics
import subprocess

import torch

from cslam_tpu_torch import _build
from cslam_tpu_torch.ops import knn_pallas as kp

SHAPES = [  # (n_valid, dim, batch, k): headline, mid batch, slice
    (100000, 512, 256, 10), (100000, 512, 256, 1), (100000, 512, 64, 10),
    (1000, 512, 1, 1)]
STAMPS = '''
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define SLOT ((blockIdx.y * gridDim.x + blockIdx.x) * 8)
#define STAMP(f) \\
  if (threadIdx.x == 0 && g_stamps) g_stamps[SLOT + (f)] = stamp_now();
'''
# (line in the kernel source, the same line with its stamps)
EDITS = [
    ("  prepare_queries<bf16, NT, QB>(a, q0, nq);",
     "  STAMP(0)\n  prepare_queries<bf16, NT, QB>(a, q0, nq);\n  STAMP(1)"),
    ("      const int tile0 = row_begin + (it / nk) * M_RT;\n"
     "      float inv[4][2];\n",
     "      const int tile0 = row_begin + (it / nk) * M_RT;\n"
     "      const unsigned long long t_epi = stamp_now();\n"
     "      float inv[4][2];\n"),
    ("      merge_tile<M_RT, NWARPS>(L, S, M_SP, tile0, nq);\n",
     "      merge_tile<M_RT, NWARPS>(L, S, M_SP, tile0, nq);\n"
     "      if (threadIdx.x == 0 && g_stamps)\n"
     "        g_stamps[SLOT + 5] += stamp_now() - t_epi;\n"),
    ("  cp_async_wait<0>();\n  finish<NWARPS>(L, a, q0, nq);",
     "  cp_async_wait<0>();\n  STAMP(2)\n  finish<NWARPS>(L, a, q0, nq);"),
    ("  if (!last) return;", "  STAMP(3)\n  if (!last) return;"),
    ("  if (tid == 0) { ctr[0] = 0; ctr[1] = 0; ctr[2] = 0; }\n}",
     "  if (tid == 0) { ctr[0] = 0; ctr[1] = 0; ctr[2] = 0; }\n  STAMP(4)\n}"),
]


def build_stamped():
    src = (_build.SRC_DIR / "cosine_topk.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + STAMPS, 1)
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"kernel source changed; no single {old!r}")
        src = src.replace(old, new)
    src += ('\nextern "C" int set_stamps(void* p) {\n'
            '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n')
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "cosine_topk_stamped.cu"
    lib_path = _build.BUILD_DIR / "libcosine_topk_stamped.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu),
                    "-o", str(lib_path)], check=True, capture_output=True,
                   timeout=_build.NVCC_TIMEOUT_S)
    lib = ctypes.CDLL(str(lib_path))
    # the copy holds this source's entry points only; the searches here
    # launch through cosine_topk_launch
    argtypes, restype = _build.SIGNATURES["cosine_topk_launch"]
    lib.cosine_topk_launch.argtypes = argtypes
    lib.cosine_topk_launch.restype = restype
    lib.set_stamps.argtypes = [ctypes.c_void_p]
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("knn_phase_times needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    lib = build_stamped()
    _build._lib = lib  # searches here run the stamped copy
    stamps = torch.zeros(8 * 4096, dtype=torch.int64, device="cuda")
    if lib.set_stamps(stamps.data_ptr()) != 0:
        raise RuntimeError("set_stamps failed")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n_valid, dim, batch, k in SHAPES:
        data = torch.randn((n_valid, dim), generator=gen,
                           device="cuda").to(torch.bfloat16)
        queries = torch.randn((batch, dim), generator=gen, device="cuda")
        norms = torch.linalg.vector_norm(data.float(), dim=1)
        for _ in range(3):
            kp.cosine_topk_pallas(data, n_valid, queries, k,
                                  data_norms=norms)
        torch.cuda.synchronize()
        stamps.zero_()
        kp.cosine_topk_pallas(data, n_valid, queries, k, data_norms=norms)
        torch.cuda.synchronize()
        qb, rt = kp.block_shape(torch.bfloat16, batch)
        splits, _ = kp.split_plan(batch, n_valid, qb, rt)
        blocks = splits * -(-batch // qb)
        t = stamps[:8 * blocks].view(blocks, 8).double().cpu() / 1e3  # us
        t0 = float(t[:, 0].min())
        merging = t[:, 4] > 0

        def stat(x):
            x = x.tolist()
            return {"median": statistics.median(x), "max": max(x)}

        end = max(float(t[:, 2].max()), float(t[:, 4].max()))
        print(json.dumps({
            "shape": {"n_valid": n_valid, "dim": dim, "batch": batch,
                      "k": k},
            "blocks": blocks, "splits": splits, "span_us": end - t0,
            "prepare_us": stat(t[:, 1] - t[:, 0]),
            "loop_us": stat(t[:, 2] - t[:, 1]),
            "epilogue_merge_us": stat(t[:, 5]),
            "publish_us": stat(t[:, 3] - t[:, 2]) if splits > 1 else None,
            "final_merge_us": (t[merging, 4] - t[merging, 3]).tolist(),
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
