// Exact cosine top-k search over a descriptor database, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces cslam_tpu/ops/knn_pallas.py:_knn_kernel (launched by
// cosine_topk_pallas) together with the input preparation of that
// wrapper. Same function: for B raw float32 queries against the first
// n_valid rows of an (N_cap, D) float32 or bfloat16 database with cached
// float32 row norms, return the k best rows by
//   sim = dot(q_n, row) * inv[row],  q_n = q / max(|q|, 1e-12) rounded
//   to the data dtype,  inv = 1 / max(norm, 1e-12)  (IEEE division),
// sorted by value descending, ties to the lower row. Slots past the
// admissible rows hold -3e38 with row 0, as in the Pallas kernel.
// Float32 products are plain FMAs, never TF32; a bf16 x bf16 product is
// exact in float32, so only the summation order differs from the plain
// version.
//
// One launch is one pass of width kp <= 64. A pass may start after a
// pair (after_v, after_i) per query: a row is admissible only when it
// ranks strictly after that pair in (value desc, row asc), a total
// order, so passes of 64 concatenate to the exact top-k for any k (the
// wrapper chains them). Values are bit-identical between passes: the
// kernel, its grid and every summation order depend on (B, n_valid, D)
// only.
//
// Design. The Pallas grid walks row tiles in order on one TPU core and
// carries a running top-k in VMEM. Here the grid is (query blocks, row
// splits): the valid rows are cut into about 264 / query-blocks
// contiguous ranges, so that even B = 1 (search_best, the slice's call)
// spreads over the card. Each block
//   1. takes a ticket on its query block's arrival counter; the first
//      block to arrive normalizes the query block in float32 into a
//      (B, D) scratch of the data dtype and raises a ready flag, the
//      others wait for it (the first block is running, so the wait
//      ends). Normalized once per launch: when every block wrote the
//      same lines, the writers stalled each other;
//   2. walks its range tile by tile, computes the tile's (QB x RT) dots,
//      scales by inv (norms fetched when the tile starts), masks rows
//      past n_valid and rows not after the pass's start pair, and merges
//      the tile into a sorted per-query top-kp behind the reference's
//      gate: a warp votes whether any candidate beats the kp-th best;
//      if one does, the warp takes the best remaining candidate (a max
//      and a min reduction over order keys) and inserts it into the
//      query's list, held in the warp's registers for the tile (a
//      shuffle shift), while it beats the kp-th best;
//   3. writes its (QB, kp) lists to a (B, splits, kp) scratch, fences,
//      and takes a ticket on the query block's finish counter. The block
//      that draws the last ticket merges the splits' lists (read with
//      __ldcg, past L1, the next batch fetched before the current one is
//      merged) with the same gated merge, writes the output, and resets
//      the counters to 0 for the next launch on the stream.
// Main loops:
//   float32, B > 4: QB = 32 queries x RT = 64 rows per tile, 256
//     threads, an smem-tiled FMA product (each thread 2 queries x 4
//     rows) fed by a 4-stage ring of 4-byte cp.async copies into k-major
//     tiles.
//   float32, B <= 4: the same FMAs with the rows read straight from
//     global memory, 16 bytes a lane, 16 rows' loads in flight per lane,
//     and the queries staged in shared memory (64-row tiles, 8 rows a
//     warp). At B = 1 the tiled loop spends 31 of every 32 products
//     and its shared-memory traffic on padding queries.
//   bfloat16: mma.sync.m16n8k16 bf16 -> f32 on the tensor cores, fed by
//     ldmatrix from a 4-stage ring of 16-byte cp.async.cg copies (depth
//     32 per stage; the ring runs across tiles, so the next tile's first
//     chunks load during a tile's epilogue). RT = 128 rows per tile;
//     QB = 64 with 8 warps, each 32 queries x 32 rows (2 x 4 MMA tiles,
//     32 accumulators), or, for B <= 16, QB = 16 with 4 warps, each
//     16 queries x 32 rows. Queries are A (row-major [q][d]); database
//     rows are B, whose [row][d] layout is the "col" operand, so plain
//     (non-.trans) ldmatrix yields its fragments. Shared rows are padded
//     to 40 elements (80 bytes): the 8 rows an ldmatrix phase reads fall
//     in 8 distinct 16-byte bank groups. Where D % 8 != 0 (or the data
//     is not 16-byte aligned) the same kernel fills each stage by masked
//     scalar loads instead. 64 x 128 x 4 stages keeps two blocks (16
//     warps) on an SM with the kp-sized lists.
//
// Bound at the headline shape (100,000 x 512 valid rows, B = 256,
// k = 10), from the shapes, not measured:
//   bf16: 102.4 MB read = 30.6 us at 3.35 TB/s; 2*256*100000*512 =
//         26.2 GFLOP = 26.5 us at 989 TFLOP/s -> bytes, ~31 us.
//   f32 (no TF32): 204.8 MB = 61 us; 26.2 GFLOP at 67 TFLOP/s = 391 us
//         -> operations, ~391 us.
// What the previous design left, and what this one does about it:
//   - products on the CUDA cores, bf16 at the f32 FMA rate: bf16 now
//     runs on the tensor cores (mma.sync); f32 keeps its FMA loop;
//   - two launches per search (partial, merge): one, with the merge in
//     the last block of each query block;
//   - about ten small torch ops per search for normalization, inverse
//     norms and a bias row: done inside the kernel (masking by n_valid
//     replaces the bias row).
// Host entry points: cosine_topk_launch (one pass, queued on the
// caller's stream) and cosine_topk_search_sync (one search of a
// database in one call: its staged rows, the query's upload, one pass,
// the results' copy back and a synchronize of its own stream).
// What it still leaves: no TMA and no wgmma (mma.sync reaches a part of
// the tensor-core peak only), and every query block re-reads its rows
// and every tile its queries through L2 (about 6x the HBM bytes at the
// headline shape, which bounds the bf16 main loop); no register tiling
// for f32 (its tiled loop is bound by shared-memory loads, 3 per 8
// FMAs); bf16 at B = 1 uses 1/16 of each MMA; each split starts its
// lists empty, so the gated merge inserts about kp (1 + ln tiles) times
// per query and split, and the last block's merge of splits x kp
// candidates per query is serial per warp.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int KMAX = 64;          // widest pass
constexpr int MAX_SPLITS = 1024;
constexpr float NEG_LARGE = -3.0e38f;
constexpr float EPS = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* data;      // (N_cap, D) float32 or bfloat16
  const float* norms;    // (N_cap,) float32 norms of the stored rows
  const float* queries;  // (B, D) raw float32 queries
  void* qn;              // (B, D) scratch: normalized queries, data dtype
  int n_valid, D, B, kp, rows_per_split;
  const float* after_v;  // pass start pair, stride ld_after; null on the
  const int* after_i;    //   first pass
  int ld_after;
  float* cand_v;         // (B, splits, kp) per-split lists
  int* cand_i;
  unsigned* tickets;     // COUNTERS per query block, 0 between launches
  float* out_v;          // (B, kp), row stride ld_out
  int* out_i;
  int ld_out;
  int vec;               // rows and queries allow 16-byte loads
};

// (v, i) ranks before (w, j): larger value first, then lower row.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void store_rn(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_rn(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(x.x);
  lo.y = __float2bfloat16_rn(x.y);
  hi.x = __float2bfloat16_rn(x.z);
  hi.y = __float2bfloat16_rn(x.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Queries q0 .. q0 + nq - 1 normalized into a.qn by groups of TPQ
// threads per query: each thread sums the squares of its slice (16-byte
// loads where the layout allows), a butterfly inside the group gives all
// of them the same total, and each divides and stores its slice.
template <typename T, int NT, int QB>
__device__ void normalize_queries(const Args& a, int q0, int nq) {
  constexpr int TPQ = NT / QB < 32 ? NT / QB : 32;
  const int q = threadIdx.x / TPQ, part = threadIdx.x % TPQ;
  const bool mine = q < nq;
  const int D = a.D;
  const float* src = a.queries + (size_t)(q0 + (mine ? q : 0)) * D;
  T* dst = static_cast<T*>(a.qn) + (size_t)(q0 + (mine ? q : 0)) * D;
  const bool v4 = D % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a.queries) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.qn) % 16 == 0;
  float ss = 0.f;
  if (mine && v4) {
#pragma unroll 8
    for (int d = 4 * part; d < D; d += 4 * TPQ) {
      const float4 x = *reinterpret_cast<const float4*>(src + d);
      ss = fmaf(x.w, x.w, fmaf(x.z, x.z, fmaf(x.y, x.y, fmaf(x.x, x.x, ss))));
    }
  } else if (mine) {
#pragma unroll 8
    for (int d = part; d < D; d += TPQ) ss = fmaf(src[d], src[d], ss);
  }
#pragma unroll
  for (int off = TPQ / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(FULL, ss, off);
  const float nrm = fmaxf(sqrtf(ss), EPS);
  if (mine && v4) {
#pragma unroll 4
    for (int d = 4 * part; d < D; d += 4 * TPQ) {
      const float4 x = *reinterpret_cast<const float4*>(src + d);
      store4(dst + d,
             make_float4(x.x / nrm, x.y / nrm, x.z / nrm, x.w / nrm));
    }
  } else if (mine) {
#pragma unroll 4
    for (int d = part; d < D; d += TPQ) store_rn(dst + d, src[d] / nrm);
  }
}

// Counters of a query block in a.tickets: blocks arrived, queries
// ready, blocks finished. All three are 0 between launches.
constexpr int COUNTERS = 3;

// The query block's normalized queries in a.qn: the first of its blocks
// to arrive writes them and raises the ready flag; the others wait for
// the flag. The first block is already running, so the wait always
// ends; and the queries are normalized once per launch, not once per
// block (blocks writing the same lines side by side stall each other).
template <typename T, int NT, int QB>
__device__ void prepare_queries(const Args& a, int q0, int nq) {
  __shared__ bool first;
  unsigned* ctr = a.tickets + COUNTERS * blockIdx.x;
  if (threadIdx.x == 0) first = atomicAdd(ctr, 1u) == 0;
  __syncthreads();
  if (first) {
    normalize_queries<T, NT, QB>(a, q0, nq);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(ctr + 1, 1u);
  } else {
    if (threadIdx.x == 0)
      while (atomicAdd(ctr + 1, 0u) == 0) __nanosleep(64);
    __syncthreads();
  }
  __threadfence();
}

// The block's running lists, [QB][kp] in shared memory, and the pass's
// start pair of each query.
struct Lists {
  float* v;
  int* i;
  float* after_v;
  int* after_i;
  int kp;
  __device__ __forceinline__ float* vq(int q) const { return v + q * kp; }
  __device__ __forceinline__ int* iq(int q) const { return i + q * kp; }
};

__host__ __device__ constexpr size_t lists_bytes(int qb, int kp) {
  return sizeof(float) * (size_t)qb * (2 * kp + 2);
}

template <int QB, int NT>
__device__ Lists init_lists(float* base, const Args& a, int q0, int nq) {
  Lists L;
  L.kp = a.kp;
  L.v = base;
  L.i = reinterpret_cast<int*>(base + QB * a.kp);
  L.after_v = base + 2 * QB * a.kp;
  L.after_i = reinterpret_cast<int*>(L.after_v + QB);
  for (int e = threadIdx.x; e < QB * a.kp; e += NT) {
    L.v[e] = NEG_LARGE;
    L.i[e] = 0;
  }
  for (int q = threadIdx.x; q < QB; q += NT) {
    const bool has = a.after_v != nullptr && q < nq;
    L.after_v[q] = has ? a.after_v[(size_t)(q0 + q) * a.ld_after] : 0.f;
    L.after_i[q] = has ? a.after_i[(size_t)(q0 + q) * a.ld_after] : 0;
  }
  return L;
}

// A row's norm, fetched when its tile starts (1 past the range), and
// its inverse, taken when the tile ends.
__device__ __forceinline__ float row_norm(const Args& a, int row,
                                          int row_end) {
  return row < row_end ? a.norms[row] : 1.f;
}
__device__ __forceinline__ float inv_of(float norm) {
  return 1.f / fmaxf(norm, EPS);
}

// A tile value as it enters the merge: -inf for a row past the range or
// not strictly after the pass's start pair (-inf never enters a list).
__device__ __forceinline__ float admit(const Lists& L, const Args& a, int q,
                                       int row, int row_end, float dot,
                                       float inv) {
  if (row >= row_end) return -CUDART_INF_F;
  const float v = dot * inv;
  if (a.after_v != nullptr && !better(L.after_v[q], L.after_i[q], v, row))
    return -CUDART_INF_F;
  return v;
}

// One query's sorted list of width kp <= 64 held in a warp's registers:
// entry j is (v[j / 32], i[j / 32]) of lane j % 32. Entries at and past
// kp are never read.
struct WarpList {
  float v[2];
  int i[2];

  __device__ __forceinline__ void load(const float* tv, const int* ti,
                                       int kp, int lane) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      v[h] = j < kp ? tv[j] : -CUDART_INF_F;
      i[h] = j < kp ? ti[j] : 0x7fffffff;
    }
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int h = 0; h < 2; ++h) { v[h] = NEG_LARGE; i[h] = 0; }
  }
  __device__ __forceinline__ void store(float* tv, int* ti, int kp,
                                        int lane) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane + 32 * h < kp) {
        tv[lane + 32 * h] = v[h];
        ti[lane + 32 * h] = i[h];
      }
  }
  // the kp-th best entry, in every lane
  __device__ __forceinline__ void kth(int kp, float& kv, int& ki) const {
    const int j = kp - 1;
    kv = __shfl_sync(FULL, j < 32 ? v[0] : v[1], j & 31);
    ki = __shfl_sync(FULL, j < 32 ? i[0] : i[1], j & 31);
  }
  // Insert (cv, cr), which beats the kp-th entry: count the entries that
  // rank before it, shift the rest one place up, drop the last.
  __device__ __forceinline__ void insert(float cv, int cr, int kp,
                                         int lane) {
    const bool b0 = lane < kp && better(v[0], i[0], cv, cr);
    const bool b1 = lane + 32 < kp && better(v[1], i[1], cv, cr);
    const int pos = __popc(__ballot_sync(FULL, b0)) +
                    __popc(__ballot_sync(FULL, b1));
    const float u0 = __shfl_up_sync(FULL, v[0], 1);
    const float u1 = __shfl_up_sync(FULL, v[1], 1);
    const int w0 = __shfl_up_sync(FULL, i[0], 1);
    const int w1 = __shfl_up_sync(FULL, i[1], 1);
    const float c = __shfl_sync(FULL, v[0], 31);
    const int ci = __shfl_sync(FULL, i[0], 31);
    if (lane == pos) { v[0] = cv; i[0] = cr; }
    else if (lane > pos) { v[0] = u0; i[0] = w0; }
    if (lane + 32 == pos) { v[1] = cv; i[1] = cr; }
    else if (lane + 32 > pos) { v[1] = lane ? u1 : c; i[1] = lane ? w1 : ci; }
  }
};

// Order-preserving key of a float (-0 counts as +0, as in `better`).
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned u = __float_as_uint(v + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Offer U candidates per lane to a warp's list whose kp-th entry is
// (kv, ki). Best first, as the reference's gate: the warp takes the best
// remaining candidate (value desc, row asc: a max then a min reduction)
// and inserts it while it beats the kp-th entry, so a tile or a batch
// costs one insertion per candidate that enters and one reduction more.
template <int U>
__device__ __forceinline__ void offer(float (&v)[U], const int (&r)[U],
                                      WarpList& W, float& kv, int& ki,
                                      int kp, int lane) {
  for (int trip = 0; trip < kp; ++trip) {
    float bv = v[0];
    int bi = r[0];
#pragma unroll
    for (int u = 1; u < U; ++u)
      if (better(v[u], r[u], bv, bi)) { bv = v[u]; bi = r[u]; }
    const unsigned mk = __reduce_max_sync(FULL, key_of(bv));
    const int mi =
        __reduce_min_sync(FULL, key_of(bv) == mk ? bi : 0x7fffffff);
    const float mv = value_of(mk);
    if (!better(mv, mi, kv, ki)) return;
    W.insert(mv, mi, kp, lane);
    W.kth(kp, kv, ki);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r[u] == mi && key_of(v[u]) == mk) v[u] = -CUDART_INF_F;
  }
}

// Merge one finished tile, S[q * pitch + r] for r < RT, into the lists.
// Gated as in the reference: a query whose tile holds nothing that beats
// its kp-th best costs one vote.
template <int RT, int NWARPS>
__device__ void merge_tile(const Lists& L, const float* S, int pitch,
                           int tile0, int nq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kp = L.kp;
  for (int q = warp; q < nq; q += NWARPS) {
    float v[RT / 32];
    int r[RT / 32];
    float kv = L.vq(q)[kp - 1];
    int ki = L.iq(q)[kp - 1];
    bool any = false;
#pragma unroll
    for (int u = 0; u < RT / 32; ++u) {
      v[u] = S[q * pitch + lane + 32 * u];
      r[u] = tile0 + lane + 32 * u;
      any |= better(v[u], r[u], kv, ki);
    }
    if (!__any_sync(FULL, any)) continue;
    WarpList W;
    W.load(L.vq(q), L.iq(q), kp, lane);
    offer<RT / 32>(v, r, W, kv, ki, kp, lane);
    W.store(L.vq(q), L.iq(q), kp, lane);
  }
}

// After the block's last tile: publish its lists; the last block of the
// query block to arrive merges all splits and writes the output.
template <int NWARPS>
__device__ void finish(const Lists& L, const Args& a, int q0, int nq) {
  constexpr int NT = NWARPS * 32;
  constexpr int MU = 8;  // candidates per lane per batch
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int splits = gridDim.y, kp = a.kp;
  __syncthreads();
  if (splits == 1) {
    if (tid == 0) {
      unsigned* ctr = a.tickets + COUNTERS * blockIdx.x;
      ctr[0] = 0;
      ctr[1] = 0;
    }
    for (int e = tid; e < nq * kp; e += NT) {
      const int q = e / kp, j = e % kp;
      a.out_v[(size_t)(q0 + q) * a.ld_out + j] = L.v[e];
      a.out_i[(size_t)(q0 + q) * a.ld_out + j] = L.i[e];
    }
    return;
  }
  for (int e = tid; e < nq * kp; e += NT) {
    const int q = e / kp, j = e % kp;
    const size_t o = ((size_t)(q0 + q) * splits + blockIdx.y) * kp + j;
    a.cand_v[o] = L.v[e];
    a.cand_i[o] = L.i[e];
  }
  __threadfence();
  __syncthreads();
  unsigned* ctr = a.tickets + COUNTERS * blockIdx.x;
  if (tid == 0) last = atomicAdd(ctr + 2, 1u) == (unsigned)(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The warp walks its queries' candidate lists in batches of 32 * MU,
  // fetching the next batch (past L1) before it merges the current one.
  const int n = splits * kp;
  const int nb = (n + 32 * MU - 1) / (32 * MU);
  const int mine = nq > warp ? (nq - warp + NWARPS - 1) / NWARPS : 0;
  float v[MU], nv[MU];
  int r[MU], nr[MU];
  auto fetch = [&](int f, float (&fv)[MU], int (&fr)[MU]) {
    const int q = warp + NWARPS * (f / nb);
    const int e0 = (f % nb) * 32 * MU;
    const float* cv = a.cand_v + (size_t)(q0 + q) * n;
    const int* ci = a.cand_i + (size_t)(q0 + q) * n;
#pragma unroll
    for (int u = 0; u < MU; ++u) {
      const int e = e0 + lane + 32 * u;
      fv[u] = e < n ? __ldcg(cv + e) : -CUDART_INF_F;
      fr[u] = e < n ? __ldcg(ci + e) : 0x7fffffff;
    }
  };
  if (mine > 0) fetch(0, v, r);
  WarpList W;
  float kv = NEG_LARGE;
  int ki = 0;
  for (int f = 0; f < mine * nb; ++f) {
    if (f + 1 < mine * nb) fetch(f + 1, nv, nr);
    if (f % nb == 0) { W.clear(); kv = NEG_LARGE; ki = 0; }
    offer<MU>(v, r, W, kv, ki, kp, lane);
    if (f % nb == nb - 1) {
      const int q = warp + NWARPS * (f / nb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (j < kp) {
          a.out_v[(size_t)(q0 + q) * a.ld_out + j] = W.v[h];
          a.out_i[(size_t)(q0 + q) * a.ld_out + j] = W.i[h];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MU; ++u) { v[u] = nv[u]; r[u] = nr[u]; }
  }
  if (tid == 0) { ctr[0] = 0; ctr[1] = 0; ctr[2] = 0; }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Async copies; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------
// float32: smem-tiled FMA product on the CUDA cores (never TF32), fed by
// a 4-stage ring of 4-byte cp.async copies into k-major tiles.

constexpr int F_QB = 32, F_RT = 64, F_KC = 32, F_NT = 256, F_STAGES = 4;
constexpr int F_QP = F_QB + 1, F_RP = F_RT + 4, F_SP = F_RT + 1;

constexpr size_t f32_smem_bytes(int kp) {
  return sizeof(float) * (F_STAGES * F_KC * (F_QP + F_RP) + F_QB * F_SP) +
         lists_bytes(F_QB, kp);
}

__global__ void __launch_bounds__(F_NT) topk_f32(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);    // [STAGES][KC][QP]
  float* Rs = Qs + F_STAGES * F_KC * F_QP;       // [STAGES][KC][RP]
  float* S = Rs + F_STAGES * F_KC * F_RP;        // [QB][SP]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * F_QB;
  const int nq = min(F_QB, a.B - q0);
  const int row_begin = blockIdx.y * a.rows_per_split;
  const int row_end = min(a.n_valid, row_begin + a.rows_per_split);
  const int D = a.D;
  const float* data = static_cast<const float*>(a.data);
  const float* qn = static_cast<const float*>(a.qn);
  const Lists L = init_lists<F_QB, F_NT>(S + F_QB * F_SP, a, q0, nq);
  prepare_queries<float, F_NT, F_QB>(a, q0, nq);

  const int nk = (D + F_KC - 1) / F_KC;
  const int ntiles =
      row_end > row_begin ? (row_end - row_begin + F_RT - 1) / F_RT : 0;
  const int total = ntiles * nk;
  auto load = [&](int it) {
    float* qs = Qs + (it % F_STAGES) * F_KC * F_QP;
    float* rs = Rs + (it % F_STAGES) * F_KC * F_RP;
    const int tile0 = row_begin + (it / nk) * F_RT;
    const int k0 = (it % nk) * F_KC;
    for (int e = tid; e < F_QB * F_KC; e += F_NT) {
      const int q = e / F_KC, c = e % F_KC;
      const bool ok = q < nq && k0 + c < D;
      cp_async4(qs + c * F_QP + q,
                ok ? qn + (size_t)(q0 + q) * D + k0 + c : qn, ok ? 4 : 0);
    }
    for (int e = tid; e < F_RT * F_KC; e += F_NT) {
      const int r = e / F_KC, c = e % F_KC;
      const bool ok = tile0 + r < row_end && k0 + c < D;
      cp_async4(rs + c * F_RP + r,
                ok ? data + (size_t)(tile0 + r) * D + k0 + c : data,
                ok ? 4 : 0);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < total) load(s);
    else cp_async_commit();
  }
  // thread owns queries {ty, ty + 16} x rows 4tx .. 4tx + 3
  const int ty = tid / 16, tx = tid % 16;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float nrm[4];
  for (int it = 0; it < total; ++it) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    if (it + F_STAGES - 1 < total) load(it + F_STAGES - 1);
    else cp_async_commit();
    if (it % nk == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        nrm[j] = row_norm(a, row_begin + (it / nk) * F_RT + 4 * tx + j,
                          row_end);
    }
    const float* qs = Qs + (it % F_STAGES) * F_KC * F_QP;
    const float* rs = Rs + (it % F_STAGES) * F_KC * F_RP;
#pragma unroll 8
    for (int c = 0; c < F_KC; ++c) {
      const float a0 = qs[c * F_QP + ty];
      const float a1 = qs[c * F_QP + ty + 16];
      const float4 b = *reinterpret_cast<const float4*>(rs + c * F_RP + 4 * tx);
      acc[0][0] = fmaf(a0, b.x, acc[0][0]);
      acc[0][1] = fmaf(a0, b.y, acc[0][1]);
      acc[0][2] = fmaf(a0, b.z, acc[0][2]);
      acc[0][3] = fmaf(a0, b.w, acc[0][3]);
      acc[1][0] = fmaf(a1, b.x, acc[1][0]);
      acc[1][1] = fmaf(a1, b.y, acc[1][1]);
      acc[1][2] = fmaf(a1, b.z, acc[1][2]);
      acc[1][3] = fmaf(a1, b.w, acc[1][3]);
    }
    if (it % nk == nk - 1) {  // the tile is complete
      const int tile0 = row_begin + (it / nk) * F_RT;
      float inv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) inv[j] = inv_of(nrm[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = ty + 16 * i, r = 4 * tx + j;
          S[q * F_SP + r] = admit(L, a, q, tile0 + r, row_end, acc[i][j],
                                  inv[j]);
          acc[i][j] = 0.f;
        }
      __syncthreads();
      merge_tile<F_RT, F_NT / 32>(L, S, F_SP, tile0, nq);
    }
  }
  cp_async_wait<0>();
  finish<F_NT / 32>(L, a, q0, nq);
}

// ---------------------------------------------------------------------
// float32, B <= 4 (search_best's B = 1): the same FMAs with the rows read
// straight from global memory, 16 bytes a lane, and the block's queries
// staged in shared memory. Warp w owns rows 8w .. 8w + 7 of a 64-row
// tile; each lane sums its slice of D for all 8 rows x 4 queries, then a
// transposing butterfly leaves the (row, query) = (lane / 4, lane % 4)
// dot product in each lane. No padded query costs a load or an FMA in
// the inner loop, and 16 rows' loads are in flight per lane.

constexpr int G_QB = 4, G_RT = 64, G_NT = 256, G_DC = 1024, G_SP = G_RT + 1;

constexpr size_t gemv_smem_bytes(int kp) {
  return sizeof(float) * (G_QB * G_DC + G_QB * G_SP) + lists_bytes(G_QB, kp);
}

__device__ __forceinline__ float dot4(float4 x, float4 q, float acc) {
  return fmaf(x.w, q.w, fmaf(x.z, q.z, fmaf(x.y, q.y, fmaf(x.x, q.x, acc))));
}

// One step of a transposing butterfly over 32 per-lane partial sums:
// afterwards acc[e] (e < W) holds entry e + W * (bit W of the lane), so
// after the steps 16, 8, 4, 2, 1 acc[0] is the full sum of entry `lane`.
template <int W>
__device__ __forceinline__ void fold(float (&acc)[32], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const float send = upper ? acc[e] : acc[e + W];
    const float keep = upper ? acc[e + W] : acc[e];
    acc[e] = keep + __shfl_xor_sync(FULL, send, W);
  }
}

__global__ void __launch_bounds__(G_NT) topk_f32_gemv(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qc = reinterpret_cast<float*>(smem);  // [QB][DC]: a depth chunk
  float* S = Qc + G_QB * G_DC;                  // [QB][SP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * G_QB;
  const int nq = min(G_QB, a.B - q0);
  const int row_begin = blockIdx.y * a.rows_per_split;
  const int row_end = min(a.n_valid, row_begin + a.rows_per_split);
  const int D = a.D;
  const float* data = static_cast<const float*>(a.data);
  const float* qn = static_cast<const float*>(a.qn);
  const Lists L = init_lists<G_QB, G_NT>(S + G_QB * G_SP, a, q0, nq);
  prepare_queries<float, G_NT, G_QB>(a, q0, nq);

  for (int tile0 = row_begin; tile0 < row_end; tile0 += G_RT) {
    const int my_row = tile0 + warp * 8 + lane / 4;  // after the butterfly
    const float nrm = row_norm(a, my_row, row_end);
    float acc[32];  // this lane's partial sums: row r, query q at 4r + q
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int dc = 0; dc < D; dc += G_DC) {
      const int dn = min(G_DC, D - dc);
      __syncthreads();
      for (int e = tid; e < G_QB * dn; e += G_NT) {
        const int q = e / dn, d = e % dn;
        Qc[q * G_DC + d] =
            q < nq ? __ldcg(qn + (size_t)(q0 + q) * D + dc + d) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r0 = 0; r0 < 8; r0 += 4) {
        const float* rp[4];
        bool ok[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = tile0 + warp * 8 + r0 + j;
          ok[j] = row < row_end;
          rp[j] = data + (size_t)(ok[j] ? row : 0) * D + dc;
        }
        if (a.vec) {
#pragma unroll 4
          for (int d = 4 * lane; d < dn; d += 128) {
            float4 x[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              x[j] = ok[j] ? *reinterpret_cast<const float4*>(rp[j] + d)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int q = 0; q < G_QB; ++q) {
              const float4 qq =
                  *reinterpret_cast<const float4*>(Qc + q * G_DC + d);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[(r0 + j) * 4 + q] = dot4(x[j], qq, acc[(r0 + j) * 4 + q]);
            }
          }
        } else {
#pragma unroll 4
          for (int d = lane; d < dn; d += 32) {
            float x[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) x[j] = ok[j] ? rp[j][d] : 0.f;
#pragma unroll
            for (int q = 0; q < G_QB; ++q) {
              const float qq = Qc[q * G_DC + d];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[(r0 + j) * 4 + q] = fmaf(x[j], qq, acc[(r0 + j) * 4 + q]);
            }
          }
        }
      }
    }
    fold<16>(acc, lane);
    fold<8>(acc, lane);
    fold<4>(acc, lane);
    fold<2>(acc, lane);
    fold<1>(acc, lane);
    S[(lane % 4) * G_SP + my_row - tile0] =
        admit(L, a, lane % 4, my_row, row_end, acc[0], inv_of(nrm));
    __syncthreads();
    merge_tile<G_RT, G_NT / 32>(L, S, G_SP, tile0, nq);
  }
  finish<G_NT / 32>(L, a, q0, nq);
}

// ---------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16 on the tensor cores, fed by ldmatrix from
// a 4-stage ring of 16-byte cp.async copies. WM x 4 warps: warp (wm, wn)
// computes queries [wm * 16 * MTW, +16 * MTW) x rows [wn * 32, +32).

constexpr int M_RT = 128, M_KS = 32, M_PITCH = M_KS + 8, M_STAGES = 4;
constexpr int M_SP = M_RT + 4;

template <int QB>
constexpr size_t mma_smem_bytes(int kp) {
  return sizeof(__nv_bfloat16) * M_STAGES * (QB + M_RT) * M_PITCH +
         sizeof(float) * QB * M_SP + lists_bytes(QB, kp);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int WM, int MTW>
__global__ void __launch_bounds__(128 * WM) topk_bf16_mma(Args a) {
  constexpr int QB = 16 * MTW * WM, NT = 128 * WM, NWARPS = 4 * WM;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);        // [STAGES][QB][PITCH]
  bf16* Bs = As + M_STAGES * QB * M_PITCH;         // [STAGES][RT][PITCH]
  float* S = reinterpret_cast<float*>(Bs + M_STAGES * M_RT * M_PITCH);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, a.B - q0);
  const int row_begin = blockIdx.y * a.rows_per_split;
  const int row_end = min(a.n_valid, row_begin + a.rows_per_split);
  const int D = a.D;
  const bf16* data = static_cast<const bf16*>(a.data);
  const bf16* qn = static_cast<const bf16*>(a.qn);
  const Lists L = init_lists<QB, NT>(S + QB * M_SP, a, q0, nq);
  prepare_queries<bf16, NT, QB>(a, q0, nq);

  const int nk = (D + M_KS - 1) / M_KS;
  const int ntiles =
      row_end > row_begin ? (row_end - row_begin + M_RT - 1) / M_RT : 0;
  const int total = ntiles * nk;

  // Fill the ring slot of chunk `it`: the queries' and the tile's rows
  // at depth (it % nk) * KS; rows, queries and depth past their end are
  // zeros.
  auto load = [&](int it) {
    bf16* as = As + (it % M_STAGES) * QB * M_PITCH;
    bf16* bs = Bs + (it % M_STAGES) * M_RT * M_PITCH;
    const int tile0 = row_begin + (it / nk) * M_RT;
    const int k0 = (it % nk) * M_KS;
    if (a.vec) {
      for (int c = tid; c < QB * (M_KS / 8); c += NT) {
        const int r = c / (M_KS / 8), kk = (c % (M_KS / 8)) * 8;
        const bool ok = r < nq && k0 + kk < D;
        cp_async16(as + r * M_PITCH + kk,
                   ok ? qn + (size_t)(q0 + r) * D + k0 + kk : qn,
                   ok ? 16 : 0);
      }
      for (int c = tid; c < M_RT * (M_KS / 8); c += NT) {
        const int r = c / (M_KS / 8), kk = (c % (M_KS / 8)) * 8;
        const bool ok = tile0 + r < row_end && k0 + kk < D;
        cp_async16(bs + r * M_PITCH + kk,
                   ok ? data + (size_t)(tile0 + r) * D + k0 + kk : data,
                   ok ? 16 : 0);
      }
    } else {
      const unsigned short* qs = reinterpret_cast<const unsigned short*>(qn);
      const unsigned short* ds =
          reinterpret_cast<const unsigned short*>(data);
      unsigned short* asu = reinterpret_cast<unsigned short*>(as);
      unsigned short* bsu = reinterpret_cast<unsigned short*>(bs);
      for (int e = tid; e < QB * M_KS; e += NT) {
        const int r = e / M_KS, kk = e % M_KS;
        const bool ok = r < nq && k0 + kk < D;
        asu[r * M_PITCH + kk] =
            ok ? __ldcg(qs + (size_t)(q0 + r) * D + k0 + kk) : 0;
      }
      for (int e = tid; e < M_RT * M_KS; e += NT) {
        const int r = e / M_KS, kk = e % M_KS;
        const bool ok = tile0 + r < row_end && k0 + kk < D;
        bsu[r * M_PITCH + kk] =
            ok ? ds[(size_t)(tile0 + r) * D + k0 + kk] : 0;
      }
    }
    cp_async_commit();
  };

  float acc[MTW][4][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

#pragma unroll
  for (int s = 0; s < M_STAGES - 1; ++s) {
    if (s < total) load(s);
    else cp_async_commit();
  }
  const int g = lane >> 2, t = lane & 3;
  float nrm[4][2];
  for (int it = 0; it < total; ++it) {
    cp_async_wait<M_STAGES - 2>();
    __syncthreads();
    if (it + M_STAGES - 1 < total) load(it + M_STAGES - 1);
    else cp_async_commit();
    if (it % nk == 0) {
      const int tile0 = row_begin + (it / nk) * M_RT;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nrm[nt][j] = row_norm(a, tile0 + wn * 32 + nt * 8 + 2 * t + j,
                                row_end);
    }

    const bf16* as = As + (it % M_STAGES) * QB * M_PITCH +
                     wm * 16 * MTW * M_PITCH;
    const bf16* bs = Bs + (it % M_STAGES) * M_RT * M_PITCH +
                     wn * 32 * M_PITCH;
#pragma unroll
    for (int kk = 0; kk < M_KS; kk += 16) {
      unsigned af[MTW][4];
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
        ldmatrix_x4(af[mt], as + (mt * 16 + (lane & 15)) * M_PITCH + kk +
                                (lane >> 4) * 8);
      unsigned bfr[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bfr[np], bs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      M_PITCH +
                                  kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2],
                   bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }

    if (it % nk == nk - 1) {  // the tile is complete
      const int tile0 = row_begin + (it / nk) * M_RT;
      float inv[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) inv[nt][j] = inv_of(nrm[nt][j]);
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int q = (wm * MTW + mt) * 16 + g + 8 * (c >> 1);
            const int r = wn * 32 + nt * 8 + 2 * t + (c & 1);
            S[q * M_SP + r] = admit(L, a, q, tile0 + r, row_end,
                                    acc[mt][nt][c], inv[nt][c & 1]);
            acc[mt][nt][c] = 0.f;
          }
      __syncthreads();
      merge_tile<M_RT, NWARPS>(L, S, M_SP, tile0, nq);
    }
  }
  cp_async_wait<0>();
  finish<NWARPS>(L, a, q0, nq);
}

// Launch with `bytes` of dynamic shared memory. The most the kernel can
// ask for (kp = KMAX), which may pass the default 48 KB, is allowed once
// per device.
template <void (*K)(Args)>
cudaError_t launch(size_t max_bytes, dim3 grid, int threads, size_t bytes,
                   cudaStream_t st, const Args& a) {
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        K, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  K<<<grid, threads, bytes, st>>>(a);
  return cudaGetLastError();
}

// One pass of width kp over the queries on `st` (see cosine_topk_launch).
cudaError_t launch_pass(const void* data, int dtype, const float* norms,
                        const float* queries, void* qn, int n_valid, int D,
                        int B, int qb, int kp, int splits,
                        int rows_per_split, const float* after_v,
                        const int* after_i, int ld_after, float* cand_v,
                        int* cand_i, unsigned* tickets, float* out_v,
                        int* out_i, int ld_out, cudaStream_t st) {
  const bool qb_ok = dtype == 0 ? qb == G_QB || qb == F_QB
                                : dtype == 1 && (qb == 16 || qb == 64);
  if (!qb_ok || kp < 1 || kp > KMAX || splits < 1 || splits > MAX_SPLITS ||
      B < 1 || D < 1 || n_valid < 0 || rows_per_split < 1 ||
      ld_out < kp || ((after_v == nullptr) != (after_i == nullptr)))
    return cudaErrorInvalidValue;
  Args a;
  a.data = data;
  a.norms = norms;
  a.queries = queries;
  a.qn = qn;
  a.n_valid = n_valid;
  a.D = D;
  a.B = B;
  a.kp = kp;
  a.rows_per_split = rows_per_split;
  a.after_v = after_v;
  a.after_i = after_i;
  a.ld_after = ld_after;
  a.cand_v = cand_v;
  a.cand_i = cand_i;
  a.tickets = tickets;
  a.out_v = out_v;
  a.out_i = out_i;
  a.ld_out = ld_out;
  // 16-byte loads: D a whole number of 16-byte groups, both bases aligned
  a.vec = D % (dtype == 0 ? 4 : 8) == 0 &&
          reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(qn) % 16 == 0;
  dim3 grid((B + qb - 1) / qb, splits);
  if (dtype == 0 && qb == G_QB)
    return launch<topk_f32_gemv>(gemv_smem_bytes(KMAX), grid, G_NT,
                                 gemv_smem_bytes(kp), st, a);
  if (dtype == 0)
    return launch<topk_f32>(f32_smem_bytes(KMAX), grid, F_NT,
                            f32_smem_bytes(kp), st, a);
  if (qb == 16)
    return launch<topk_bf16_mma<1, 1>>(mma_smem_bytes<16>(KMAX), grid, 128,
                                       mma_smem_bytes<16>(kp), st, a);
  return launch<topk_bf16_mma<2, 2>>(mma_smem_bytes<64>(KMAX), grid, 256,
                                     mma_smem_bytes<64>(kp), st, a);
}

}  // namespace

// Plain C entry point for ctypes: one pass of width kp over the queries.
// dtype: 0 = float32, 1 = bfloat16. qb: queries per block (4 or 32 for
// float32; 16 or 64 for bfloat16). qn holds B * D elements of the data
// dtype; cand_* hold B * splits * kp entries (unused when splits == 1);
// tickets 3 * ceil(B / qb) zeroed counters. Launches on `stream`, does not
// synchronize, returns the launch's cudaError_t.
extern "C" int cosine_topk_launch(
    const void* data, int dtype, const float* norms, const float* queries,
    void* qn, int n_valid, int D, int B, int qb, int kp, int splits,
    int rows_per_split, const float* after_v, const int* after_i,
    int ld_after, float* cand_v, int* cand_i, unsigned* tickets,
    float* out_v, int* out_i, int ld_out, void* stream) {
  return static_cast<int>(launch_pass(
      data, dtype, norms, queries, qn, n_valid, D, B, qb, kp, splits,
      rows_per_split, after_v, after_i, ld_after, cand_v, cand_i, tickets,
      out_v, out_i, ld_out, static_cast<cudaStream_t>(stream)));
}

// One search of width kp <= KMAX as a database issues it, in one call
// from the host: the rows added since the last upload, the query, one
// pass of the kernel (the grid of cosine_topk_launch), the results back
// to the host, and a synchronize of `stream` alone. Every field is 8
// bytes (the Python side mirrors the layout in knn_pallas.SearchCall).
struct SearchCall {
  int64_t dtype, D, n_valid, B, qb, kp, splits, rows_per_split;
  int64_t row0, n_rows;     // pending rows: they go to rows row0 ...
  const void* stage_rows;   // pinned host, n_rows x D of the data dtype
  const float* stage_norms; // pinned host, their n_rows float32 norms
  const float* query;       // the caller's host (B, D) float32 queries
  float* query_pinned;      // pinned host slot, B x D
  float* query_dev;         // device copy of the queries
  void* data;               // (N_cap, D) data dtype, device
  float* norms;             // (N_cap,) float32, device
  void* qn;                 // kernel workspaces (cosine_topk_launch)
  float* cand_v;
  int* cand_i;
  unsigned* tickets;
  int* out_dev;             // device (B, kp) rows, then (B, kp) sims' bits
  int* out_host;            // pinned host, the same 2 * B * kp words
  void* stream;             // the caller's own cudaStream_t
};

// Returns a cudaError_t: of the first failed step, else of the synchronize.
extern "C" int cosine_topk_search_sync(const SearchCall* c) {
  if (c->B < 1 || c->D < 1 || c->kp < 1 || c->kp > KMAX || c->n_rows < 0 ||
      (c->dtype != 0 && c->dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  const size_t es = c->dtype == 0 ? 4 : 2;
  cudaError_t err = cudaSuccess;
  if (c->n_rows > 0) {
    err = cudaMemcpyAsync(
        static_cast<char*>(c->data) + (size_t)c->row0 * c->D * es,
        c->stage_rows, (size_t)c->n_rows * c->D * es,
        cudaMemcpyHostToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(c->norms + c->row0, c->stage_norms,
                            (size_t)c->n_rows * sizeof(float),
                            cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t q_bytes = (size_t)c->B * c->D * sizeof(float);
  memcpy(c->query_pinned, c->query, q_bytes);
  err = cudaMemcpyAsync(c->query_dev, c->query_pinned, q_bytes,
                        cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int B = (int)c->B, kp = (int)c->kp;
  err = launch_pass(c->data, (int)c->dtype, c->norms, c->query_dev, c->qn,
                    (int)c->n_valid, (int)c->D, B, (int)c->qb, kp,
                    (int)c->splits, (int)c->rows_per_split, nullptr, nullptr,
                    0, c->cand_v, c->cand_i, c->tickets,
                    reinterpret_cast<float*>(c->out_dev + (size_t)B * kp),
                    c->out_dev, kp, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyAsync(c->out_host, c->out_dev,
                        2 * (size_t)B * kp * sizeof(int),
                        cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(st));
}
