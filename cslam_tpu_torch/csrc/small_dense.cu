// Batched small dense factorizations for LOBPCG, CUDA C++ for Hopper
// (sm_90a): a symmetric eigendecomposition (n <= 16), a thin QR
// (m <= 16 rows, n <= 8 columns) and the SVD of a square matrix
// (n <= 8).
//
// Replaces no TPU kernel: the reference leaves these factorizations to
// XLA inside its compiled LOBPCG. It was added because cuSOLVER's calls
// at these sizes check their `info` on the host, a synchronization for
// each of the ~99 factorizations of a Frank-Wolfe step of MAC's warm
// LOBPCG, and a synchronization cannot be captured into a CUDA graph.
// These kernels write no status: a matrix the iteration does not
// settle leaves after a fixed number of sweeps with what it has.
//
// Bound: latency. A matrix is a few KB (12 x 12 doubles: 1.2 KB with its
// vectors); one launch moves well under 10 KB and does ~1e5 flops, so
// the time is the chain of dependent steps inside one warp. Design: one
// warp per matrix, four matrices per block; the matrix and its vectors
// live in shared memory in float64 (inputs are float32, so the results,
// rounded back to float32, are at least as accurate as float32
// cuSOLVER's).
//   eigh: parallel-order Jacobi. A sweep is n - 1 rounds (n rounded up
//     to even) of n / 2 disjoint rotations in round-robin order, every
//     pair once; lane j computes rotation j's (c, s), then the lanes
//     update the rotated columns of A and V, then the rotated rows,
//     entry by entry. Sweeps stop once the off-diagonal sum of squares
//     is below 1e-30 of the matrix's (quadratic convergence: 6-8 sweeps
//     at n = 12), or after MAX_SWEEPS. Eigenvalues ascending, ties by
//     index, NaN last; the lower triangle is read, as LAPACK's 'L'
//     does. (Cyclic order, one rotation at a time, took 0.19 ms at
//     n = 12: 66 dependent rotations a sweep.)
//   qr: Householder reflectors as LAPACK's geqr2 / larfg make them (the
//     same signs), Q accumulated backwards as org2r does; lane c owns
//     column c of each update.
//   svd: one-sided Jacobi on the columns (lane i owns row i; the three
//     dot products are butterfly reductions, bit-identical on every
//     lane), singular values descending; a column whose singular value
//     is exactly 0 gets U's column from Gram-Schmidt on unit vectors.
// The signs of eigenvectors and singular vectors are not normalized
// (neither are LAPACK's); LOBPCG does not depend on them.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NMAX = 16;  // largest order held
constexpr int LD = NMAX + 1;
constexpr int WARPS = 4;  // matrices per block
constexpr int MAX_SWEEPS = 40;
constexpr int ENTRIES = NMAX * (NMAX / 2) / 32;  // a lane's rotated entries
constexpr int QR_MAX_COLS = 8;
constexpr int SVD_MAX = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// (a, ia) ranks before (b, ib) ascending: ties by index, NaN last
__device__ __forceinline__ bool ascends(double a, int ia, double b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return (!na && nb) || (na && nb && ia < ib);
  return a < b || (a == b && ia < ib);
}

// (c, s) of the rotation J (J_pp = J_qq = c, J_pq = s, J_qp = -s) that
// zeroes the off-diagonal of J^T [[app, apq], [apq, aqq]] J
__device__ __forceinline__ void rotation(double app, double aqq, double apq,
                                         double& c, double& s) {
  const double theta = (aqq - app) / (2.0 * apq);
  const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                   (fabs(theta) + sqrt(theta * theta + 1.0));
  c = rsqrt(t * t + 1.0);
  s = t * c;
}

// slot `pos` of round r of the round-robin pairing of N (even) indices:
// slot 0 stays, the others turn; pair j of a round is (slot j, slot
// N - 1 - j), and every pair meets once in the N - 1 rounds of a sweep
__device__ __forceinline__ int round_robin(int pos, int r, int N) {
  if (pos == 0) return 0;
  const int x = pos - 1 + r;  // below 2 (N - 1)
  return 1 + (x >= N - 1 ? x - (N - 1) : x);
}

__global__ void __launch_bounds__(32 * WARPS)
    small_eigh_jacobi(const float* __restrict__ A, int batch, int n,
                      float* __restrict__ w, float* __restrict__ V) {
  __shared__ double sa[WARPS][NMAX * LD];
  __shared__ double sv[WARPS][NMAX * LD];
  __shared__ double sc[WARPS][NMAX / 2], ss[WARPS][NMAX / 2];
  __shared__ int sp[WARPS][NMAX / 2], sq[WARPS][NMAX / 2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= batch) return;  // the whole warp leaves together
  double* a = sa[warp];
  double* v = sv[warp];
  double *rc = sc[warp], *rs = ss[warp];
  int *rp = sp[warp], *rq = sq[warp];
  const float* Ab = A + static_cast<size_t>(b) * n * n;
  double fro = 0.0;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e % n;
    const double x = Ab[i >= j ? i * n + j : j * n + i];
    a[i * LD + j] = x;
    v[i * LD + j] = i == j ? 1.0 : 0.0;
    fro += x * x;
  }
  fro = warp_sum(fro);
  __syncwarp();
  const int N = n + (n & 1), half = N / 2;  // odd n: index n sits out
  // the lane's entries of a round's updates: e = lane + 32 i over the
  // n x half (index, pair) grid
  int ek[ENTRIES], ej[ENTRIES], ne = 0;
#pragma unroll
  for (int i = 0; i < ENTRIES; ++i) {
    const int e = lane + 32 * i;
    ek[i] = e / half;
    ej[i] = e % half;
    if (e < n * half) ne = i + 1;
  }
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    double off = 0.0;
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e % n;
      if (i < j) off += a[i * LD + j] * a[i * LD + j];
    }
    off = warp_sum(off);
    if (!(off > 1e-30 * fro)) break;  // a NaN ends the sweeps too
    for (int r = 0; r < N - 1; ++r) {
      // this round's disjoint rotations, one per lane j < half
      if (lane < half) {
        int p = round_robin(lane, r, N);
        int q = round_robin(N - 1 - lane, r, N);
        if (p > q) {
          const int t = p;
          p = q;
          q = t;
        }
        double c = 1.0, s = 0.0;
        if (q < n && a[p * LD + q] != 0.0)
          rotation(a[p * LD + p], a[q * LD + q], a[p * LD + q], c, s);
        else
          p = -1;  // nothing to rotate
        rp[lane] = p;
        rq[lane] = q;
        rc[lane] = c;
        rs[lane] = s;
      }
      __syncwarp();
      // columns p and q of A and V, the lane's entries (row k, pair j):
      // every load first, then every store (the entries are disjoint)
      double x[ENTRIES][4];
#pragma unroll
      for (int i = 0; i < ENTRIES; ++i) {
        if (i >= ne) break;
        const int k = ek[i], p = rp[ej[i]], q = rq[ej[i]];
        if (p < 0) continue;
        x[i][0] = a[k * LD + p];
        x[i][1] = a[k * LD + q];
        x[i][2] = v[k * LD + p];
        x[i][3] = v[k * LD + q];
      }
#pragma unroll
      for (int i = 0; i < ENTRIES; ++i) {
        if (i >= ne) break;
        const int j = ej[i], k = ek[i], p = rp[j], q = rq[j];
        if (p < 0) continue;
        const double c = rc[j], s = rs[j];
        a[k * LD + p] = c * x[i][0] - s * x[i][1];
        a[k * LD + q] = s * x[i][0] + c * x[i][1];
        v[k * LD + p] = c * x[i][2] - s * x[i][3];
        v[k * LD + q] = s * x[i][2] + c * x[i][3];
      }
      __syncwarp();
      // then rows p and q, entries (pair j, column k); the pair each
      // rotation zeroes is set to 0 exactly
#pragma unroll
      for (int i = 0; i < ENTRIES; ++i) {
        if (i >= ne) break;
        const int k = ek[i], p = rp[ej[i]], q = rq[ej[i]];
        if (p < 0) continue;
        x[i][0] = a[p * LD + k];
        x[i][1] = a[q * LD + k];
      }
#pragma unroll
      for (int i = 0; i < ENTRIES; ++i) {
        if (i >= ne) break;
        const int j = ej[i], k = ek[i], p = rp[j], q = rq[j];
        if (p < 0) continue;
        const double c = rc[j], s = rs[j];
        a[p * LD + k] = k == q ? 0.0 : c * x[i][0] - s * x[i][1];
        a[q * LD + k] = k == p ? 0.0 : s * x[i][0] + c * x[i][1];
      }
      __syncwarp();
    }
  }
  if (lane < n) {
    const double wk = a[lane * LD + lane];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += ascends(a[j * LD + j], j, wk, lane);
    w[static_cast<size_t>(b) * n + rank] = static_cast<float>(wk);
    float* Vb = V + static_cast<size_t>(b) * n * n;
    for (int i = 0; i < n; ++i)
      Vb[i * n + rank] = static_cast<float>(v[i * LD + lane]);
  }
}

__global__ void __launch_bounds__(32 * WARPS)
    small_qr_householder(const float* __restrict__ A, int batch, int m,
                         int n, float* __restrict__ Q,
                         float* __restrict__ R) {
  __shared__ double sa[WARPS][NMAX * LD];
  __shared__ double sq[WARPS][NMAX * LD];
  __shared__ double stau[WARPS][QR_MAX_COLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= batch) return;
  double* a = sa[warp];
  double* q = sq[warp];
  double* tau = stau[warp];
  const float* Ab = A + static_cast<size_t>(b) * m * n;
  for (int e = lane; e < m * n; e += 32) {
    const int i = e / n, j = e % n;
    a[i * LD + j] = Ab[i * n + j];
    q[i * LD + j] = i == j ? 1.0 : 0.0;
  }
  __syncwarp();
  // reflectors: R above the diagonal, v below it (v_j = 1 implied)
  for (int j = 0; j < n; ++j) {
    const double alpha = a[j * LD + j];
    double xs = 0.0;
    for (int i = j + 1; i < m; ++i) xs += a[i * LD + j] * a[i * LD + j];
    double t = 0.0, beta = alpha, scale = 0.0;
    if (xs > 0.0) {  // larfg: H = I when the column below is zero
      beta = -copysign(sqrt(alpha * alpha + xs), alpha);
      t = (beta - alpha) / beta;
      scale = 1.0 / (alpha - beta);
    }
    __syncwarp();  // column j read by every lane before it changes
    if (lane > j && lane < m) a[lane * LD + j] *= scale;
    if (lane == j) {
      a[j * LD + j] = beta;
      tau[j] = t;
    }
    __syncwarp();
    if (lane > j && lane < n) {
      double d = a[j * LD + lane];
      for (int i = j + 1; i < m; ++i) d += a[i * LD + j] * a[i * LD + lane];
      d *= t;
      a[j * LD + lane] -= d;
      for (int i = j + 1; i < m; ++i) a[i * LD + lane] -= d * a[i * LD + j];
    }
    __syncwarp();
  }
  // Q = H_0 ... H_{n-1} I[:, :n], applied from the last reflector back;
  // H_j leaves the columns c < j (still e_c) alone
  for (int j = n - 1; j >= 0; --j) {
    if (lane >= j && lane < n) {
      double d = q[j * LD + lane];
      for (int i = j + 1; i < m; ++i) d += a[i * LD + j] * q[i * LD + lane];
      d *= tau[j];
      q[j * LD + lane] -= d;
      for (int i = j + 1; i < m; ++i) q[i * LD + lane] -= d * a[i * LD + j];
    }
    __syncwarp();
  }
  float* Qb = Q + static_cast<size_t>(b) * m * n;
  float* Rb = R + static_cast<size_t>(b) * n * n;
  for (int e = lane; e < m * n; e += 32)
    Qb[e] = static_cast<float>(q[(e / n) * LD + e % n]);
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e % n;
    Rb[e] = j >= i ? static_cast<float>(a[i * LD + j]) : 0.0f;
  }
}

__global__ void __launch_bounds__(32 * WARPS)
    small_svd_jacobi(const float* __restrict__ A, int batch, int n,
                     float* __restrict__ U, float* __restrict__ S,
                     float* __restrict__ Vt) {
  __shared__ double sg[WARPS][SVD_MAX * SVD_MAX];
  __shared__ double sv[WARPS][SVD_MAX * SVD_MAX];
  __shared__ double ssig[WARPS][SVD_MAX];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= batch) return;
  double* g = sg[warp];
  double* v = sv[warp];
  double* sig = ssig[warp];
  const float* Ab = A + static_cast<size_t>(b) * n * n;
  for (int e = lane; e < n * n; e += 32) {
    g[e] = Ab[e];
    v[e] = e / n == e % n ? 1.0 : 0.0;
  }
  __syncwarp();
  // one-sided Jacobi: lane i owns row i of G = A V and of V
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double gp = lane < n ? g[lane * n + p] : 0.0;
        const double gq = lane < n ? g[lane * n + q] : 0.0;
        const double al = warp_sum(gp * gp), be = warp_sum(gq * gq);
        const double ga = warp_sum(gp * gq);
        if (!(fabs(ga) > 1e-15 * sqrt(al * be))) continue;
        rotated = true;
        double c, s;
        rotation(al, be, ga, c, s);
        if (lane < n) {
          g[lane * n + p] = c * gp - s * gq;
          g[lane * n + q] = s * gp + c * gq;
          const double vp = v[lane * n + p], vq = v[lane * n + q];
          v[lane * n + p] = c * vp - s * vq;
          v[lane * n + q] = s * vp + c * vq;
        }
      }
    }
    if (!rotated) break;
  }
  __syncwarp();
  if (lane < n) {
    double ss = 0.0;
    for (int i = 0; i < n; ++i) ss += g[i * n + lane] * g[i * n + lane];
    sig[lane] = sqrt(ss);
  }
  __syncwarp();
  if (lane < n) {
    const double sj = sig[lane];
    const double inv = sj > 0.0 ? 1.0 / sj : 0.0;
    for (int i = 0; i < n; ++i) g[i * n + lane] *= inv;
  }
  __syncwarp();
  if (lane == 0) {
    // U's columns for exactly zero singular values: Gram-Schmidt (twice)
    // of unit vectors against the columns held so far
    unsigned have = 0;
    for (int j = 0; j < n; ++j) have |= (sig[j] > 0.0 ? 1u : 0u) << j;
    for (int j = 0; j < n; ++j) {
      if (have >> j & 1u) continue;
      for (int e = 0; e < n; ++e) {
        double x[SVD_MAX];
        for (int i = 0; i < n; ++i) x[i] = i == e ? 1.0 : 0.0;
        for (int pass = 0; pass < 2; ++pass)
          for (int l = 0; l < n; ++l) {
            if (!(have >> l & 1u)) continue;
            double d = 0.0;
            for (int i = 0; i < n; ++i) d += g[i * n + l] * x[i];
            for (int i = 0; i < n; ++i) x[i] -= d * g[i * n + l];
          }
        double nx = 0.0;
        for (int i = 0; i < n; ++i) nx += x[i] * x[i];
        nx = sqrt(nx);
        if (nx > 0.5) {
          for (int i = 0; i < n; ++i) g[i * n + j] = x[i] / nx;
          have |= 1u << j;
          break;
        }
      }
    }
  }
  __syncwarp();
  if (lane < n) {
    const double sj = sig[lane];
    int rank = 0;  // descending: rank by the negated values
    for (int j = 0; j < n; ++j) rank += ascends(-sig[j], j, -sj, lane);
    S[static_cast<size_t>(b) * n + rank] = static_cast<float>(sj);
    float* Ub = U + static_cast<size_t>(b) * n * n;
    float* Vb = Vt + static_cast<size_t>(b) * n * n;
    for (int i = 0; i < n; ++i) {
      Ub[i * n + rank] = static_cast<float>(g[i * n + lane]);
      Vb[rank * n + i] = static_cast<float>(v[i * n + lane]);
    }
  }
}

inline dim3 grid_of(int batch) { return dim3((batch + WARPS - 1) / WARPS); }

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 when the launch was taken), or cudaErrorInvalidValue for a shape it
// does not hold. Arrays are contiguous, row-major, float32.

extern "C" int small_eigh_launch(const float* A, int batch, int n, float* w,
                                 float* V, void* stream) {
  if (batch < 1 || n < 1 || n > NMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  small_eigh_jacobi<<<grid_of(batch), 32 * WARPS, 0,
                      static_cast<cudaStream_t>(stream)>>>(A, batch, n, w,
                                                           V);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int small_qr_launch(const float* A, int batch, int m, int n,
                               float* Q, float* R, void* stream) {
  if (batch < 1 || n < 1 || n > QR_MAX_COLS || m < n || m > NMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  small_qr_householder<<<grid_of(batch), 32 * WARPS, 0,
                         static_cast<cudaStream_t>(stream)>>>(A, batch, m, n,
                                                              Q, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int small_svd_launch(const float* A, int batch, int n, float* U,
                                float* S, float* Vt, void* stream) {
  if (batch < 1 || n < 1 || n > SVD_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  small_svd_jacobi<<<grid_of(batch), 32 * WARPS, 0,
                     static_cast<cudaStream_t>(stream)>>>(A, batch, n, U, S,
                                                          Vt);
  return static_cast<int>(cudaGetLastError());
}
