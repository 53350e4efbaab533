// Exact cosine top-k search over a descriptor database, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces cslam_tpu/ops/knn_pallas.py:_knn_kernel (launched by
// cosine_topk_pallas). Same function: for B queries (normalized on the
// host, then cast to the database dtype) against the first n_valid rows
// of an (N_cap, D) float32 or bfloat16 database, return the k best
// rows by sim = dot(q, row) * inv[row] + bias[row], sorted by value
// descending, ties to the lower row. Slots past n_valid hold -3e38 with
// row 0, as in the Pallas kernel.
//
// Design. The Pallas grid walks row tiles in order on one TPU core and
// carries a running top-k in VMEM. Here blocks run in parallel on 132
// SMs and nothing carries over between them, and B is often 1
// (search_best), so blocks over queries alone would leave the card idle:
//   kernel 1: the grid splits the valid rows into S contiguous ranges
//     and the queries into blocks of QB = 32. Each block walks its range
//     in RT = 64-row tiles; a tile's (QB x RT) dots are an smem-tiled
//     float32 FMA product (bf16 is widened from the stored value, so a
//     bf16 x bf16 product is exact in f32; never TF32). Each query keeps
//     a sorted top-k in shared memory behind the reference's gate: one
//     warp takes the tile's best candidate (value desc, row asc) and
//     merges only while it beats the current k-th best; rows are walked
//     in ascending order, so a candidate that only ties the k-th best
//     never enters and ties keep the lower row. Each block writes its
//     (QB, k) list to an (S, B, k) candidate buffer.
//   kernel 2: one block per query merges the S sorted lists (k rounds
//     of a block-wide argmax over the S list heads).
//
// Bound at the headline shape (100,000 x 512 valid rows, B = 256,
// k = 10), computed from the shapes, not measured:
//   bf16: 102.4 MB read = 30.6 us at 3.35 TB/s; 2*256*100000*512 =
//         26.2 GFLOP = 26.5 us at 989 TFLOP/s -> memory-bound, ~31 us.
//   f32 (no TF32): 204.8 MB = 61 us; 26.2 GFLOP at 67 TFLOP/s = 391 us
//         -> compute-bound, ~391 us.
// What this simple design leaves on the table: the products run on the
// CUDA cores (no wgmma/tensor cores, so bf16 runs at the f32 FMA rate),
// tiles are loaded synchronously (no TMA or cp.async ring), and every
// query block re-reads its row range (the 8 query blocks of B = 256
// share it through L2 because they are scheduled side by side).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int QB = 32;      // queries per block
constexpr int RT = 64;      // rows per tile
constexpr int KC = 32;      // depth of one smem chunk
constexpr int NT = 256;     // threads per block
constexpr int KMAX = 64;    // largest supported k
constexpr int MAX_SPLITS = 1024;
constexpr float NEG_LARGE = -3.0e38f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (v, i) ranks before (w, j): larger value first, then lower row.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

template <typename T>
__global__ void __launch_bounds__(NT)
topk_partial(const T* __restrict__ data, const float* __restrict__ inv,
             const float* __restrict__ bias, const T* __restrict__ queries,
             int n_valid, int D, int B, int k, int rows_per_split,
             float* __restrict__ cand_vals, int* __restrict__ cand_idx) {
  __shared__ float Qs[KC][QB + 1];
  __shared__ __align__(16) float Rs[KC][RT + 4];
  __shared__ float S[QB][RT + 1];
  __shared__ float topv[QB][KMAX];
  __shared__ int topi[QB][KMAX];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n_valid, row_begin + rows_per_split);

  for (int e = tid; e < QB * KMAX; e += NT) {
    topv[e / KMAX][e % KMAX] = NEG_LARGE;
    topi[e / KMAX][e % KMAX] = 0;
  }

  // compute mapping: thread owns queries {ty, ty + 16} x rows 4tx..4tx+3
  const int ty = tid / 16;
  const int tx = tid % 16;

  for (int tile0 = row_begin; tile0 < row_end; tile0 += RT) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kc = 0; kc < D; kc += KC) {
      for (int e = tid; e < QB * KC; e += NT) {
        const int q = e / KC, c = e % KC;
        const int gq = q0 + q, gc = kc + c;
        Qs[c][q] = (gq < B && gc < D)
                       ? widen(queries[(size_t)gq * D + gc]) : 0.f;
      }
      for (int e = tid; e < RT * KC; e += NT) {
        const int r = e / KC, c = e % KC;
        const int row = tile0 + r, gc = kc + c;
        Rs[c][r] = (row < row_end && gc < D)
                       ? widen(data[(size_t)row * D + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < KC; ++c) {
        const float a0 = Qs[c][ty];
        const float a1 = Qs[c][ty + 16];
        const float4 b = *reinterpret_cast<const float4*>(&Rs[c][4 * tx]);
        acc[0][0] = fmaf(a0, b.x, acc[0][0]);
        acc[0][1] = fmaf(a0, b.y, acc[0][1]);
        acc[0][2] = fmaf(a0, b.z, acc[0][2]);
        acc[0][3] = fmaf(a0, b.w, acc[0][3]);
        acc[1][0] = fmaf(a1, b.x, acc[1][0]);
        acc[1][1] = fmaf(a1, b.y, acc[1][1]);
        acc[1][2] = fmaf(a1, b.z, acc[1][2]);
        acc[1][3] = fmaf(a1, b.w, acc[1][3]);
      }
      __syncthreads();
    }
    // fused normalize + mask; rows past the range can never enter
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * tx + j;
        const int row = tile0 + r;
        S[ty + 16 * i][r] = row < row_end
                                ? fmaf(acc[i][j], inv[row], bias[row])
                                : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // gated merge: warp w serves queries w, w + 8, w + 16, w + 24
    for (int q = warp; q < QB; q += NT / 32) {
      if (q0 + q >= B) break;
      float v0 = S[q][lane], v1 = S[q][lane + 32];
      const int r0 = tile0 + lane, r1 = tile0 + lane + 32;
      for (int trip = 0; trip < k; ++trip) {
        float bv = v0;
        int bi = r0;
        if (better(v1, r1, bv, bi)) { bv = v1; bi = r1; }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
        }
        if (!better(bv, bi, topv[q][k - 1], topi[q][k - 1])) break;
        if (lane == 0) {
          int p = k - 1;
          while (p > 0 && better(bv, bi, topv[q][p - 1], topi[q][p - 1])) {
            topv[q][p] = topv[q][p - 1];
            topi[q][p] = topi[q][p - 1];
            --p;
          }
          topv[q][p] = bv;
          topi[q][p] = bi;
        }
        __syncwarp();
        if (r0 == bi) v0 = -CUDART_INF_F;
        if (r1 == bi) v1 = -CUDART_INF_F;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < QB * k; e += NT) {
    const int q = e / k, j = e % k;
    if (q0 + q < B) {
      const size_t o = ((size_t)split * B + q0 + q) * k + j;
      cand_vals[o] = topv[q][j];
      cand_idx[o] = topi[q][j];
    }
  }
}

__global__ void __launch_bounds__(NT)
topk_merge(const float* __restrict__ cand_vals,
           const int* __restrict__ cand_idx, int splits, int B, int k,
           float* __restrict__ out_vals, int* __restrict__ out_idx) {
  __shared__ int head[MAX_SPLITS];
  __shared__ float wv[NT / 32];
  __shared__ int wi[NT / 32];
  __shared__ int ws[NT / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int s = tid; s < splits; s += NT) head[s] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff, bs = -1;
    for (int s = tid; s < splits; s += NT) {
      const int h = head[s];
      if (h < k) {
        const size_t o = ((size_t)s * B + b) * k + h;
        const float v = cand_vals[o];
        const int i = cand_idx[o];
        if (bs < 0 || better(v, i, bv, bi)) { bv = v; bi = i; bs = s; }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int os = __shfl_xor_sync(0xffffffffu, bs, off);
      if (os >= 0 && (bs < 0 || better(ov, oi, bv, bi))) {
        bv = ov; bi = oi; bs = os;
      }
    }
    if (lane == 0) { wv[warp] = bv; wi[warp] = bi; ws[warp] = bs; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < NT / 32; ++w) {
        if (ws[w] >= 0 && (bs < 0 || better(wv[w], wi[w], bv, bi))) {
          bv = wv[w]; bi = wi[w]; bs = ws[w];
        }
      }
      out_vals[(size_t)b * k + j] = bv;
      out_idx[(size_t)b * k + j] = bi;
      head[bs] += 1;
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16.
// cand_* hold splits * B * k entries; out_* hold B * k. Launches on
// `stream`, does not synchronize, returns cudaGetLastError().
extern "C" int cosine_topk_launch(const void* data, int dtype,
                                  const float* inv, const float* bias,
                                  const void* queries, int n_valid, int D,
                                  int B, int k, int splits,
                                  int rows_per_split, float* cand_vals,
                                  int* cand_idx, float* out_vals,
                                  int* out_idx, void* stream) {
  if (k < 1 || k > KMAX || splits < 1 || splits > MAX_SPLITS || B < 1 ||
      D < 1 || n_valid < 0 || rows_per_split < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((B + QB - 1) / QB, splits);
  if (dtype == 0) {
    topk_partial<float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(data), inv, bias,
        static_cast<const float*>(queries), n_valid, D, B, k,
        rows_per_split, cand_vals, cand_idx);
  } else {
    topk_partial<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(data), inv, bias,
        static_cast<const __nv_bfloat16*>(queries), n_valid, D, B, k,
        rows_per_split, cand_vals, cand_idx);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge<<<B, NT, 0, st>>>(cand_vals, cand_idx, splits, B, k, out_vals,
                               out_idx);
  return static_cast<int>(cudaGetLastError());
}
