// The many-state weight-sum route for Hopper (sm_90a): the split pair
// K3 denom_sums_dd and K4 wsum_denom_dd, plus the f32 column shift that
// comes before them.
//
// Replaces the TPU kernels `_denom_sums_kernel` (K3,
// pymbar_tpu/ops/pallas_kernels.py:785, called by `denom_sums_dd` :827) and
// `_wsum_denom_kernel` (K4, :890, called by `wsum_denom_dd` :932), and the
// XLA-fused `jnp.max(g_hi[:, None] - u_hi, axis=0)` that `wsum_dd` runs
// before them (:692).  Contracts, as there, with a_kn = g_k - u_kn rebuilt
// in f64 from the (hi, lo) float32 planes:
//   column shift:  m_n = max_k (g_hi_k - u_hi_kn) in float32 (hi words only)
//   K3:            s_n = sum_k exp(a_kn - m_n), the caller's global m_n
//   K4:            S_k = sum_n c_n exp(a_kn - m_n) / d_n, where a column with
//                  d_n = d_hi + d_lo <= 0 adds exactly 0 (c = 1 when absent)
// Every value is rebuilt as hi + lo in double and the arithmetic is plain
// f64 (the H100 has FP64; the TPU's double-word chains are not needed).
// K padding to a power of two and N to a tile are TPU artefacts: ragged
// edges are bounds checks, and indices are 64-bit (K N > 2^31 elements).
//
// What bounds them on the H100: bytes.  The shift reads the hi plane
// (4 B/element), K3 and K4 both planes once (8 B/element each): at the
// 8192 x 327680 many-state slice 10.7 + 21.5 + 21.5 GB, 3.2 + 6.4 + 6.4 ms
// at 3.35 TB/s.  One f64 exp per element in K3 and K4 (2.7e9 exps, ~3.4 ms
// at the measured 0.79e12 exps/s) is not far below that, so K4's row pass
// keeps copies in flight (cp.async tiles) while it computes.
// Design: the TPU kernels carry their sums across a sequential grid, which
// Hopper blocks (run in no order) cannot; every reduction here is two-level
// and deterministic, with no atomics.
//   shift_partials / denom_partials: grid (column blocks, k blocks); one
//     thread per column, threads across n so every row load is coalesced;
//     each writes its k block's max / sum to partial[kb, n].
//   shift_finish / denom_finish: one thread per column folds the k-block
//     partials in a fixed order (denom_finish splits s into hi/lo).
//   K4: denom_recip turns (d, c) into r_n = c_n / d_n (0 where d_n <= 0,
//     and NaN) and m_n into f64, then the shared row pass and finish
//     (wsum_rows.cuh: 32-row blocks over 128-column tiles staged by
//     cp.async in a 3-stage ring; a column with r_n == 0 is skipped by a
//     branch, so an overflowing exp there adds exactly 0).

#include "wsum_rows.cuh"

namespace {

constexpr int kColThreads = 256;

__global__ void __launch_bounds__(kColThreads)
shift_partials(const float* __restrict__ uh, const float* __restrict__ gh, int K,
               int64_t N, int rows_per_block, float* __restrict__ partial) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int k0 = blockIdx.y * rows_per_block;
  const int k1 = (k0 + rows_per_block < K) ? k0 + rows_per_block : K;
  float m = -INFINITY;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    m = fmaxf(m, __ldg(gh + k) - uh[(size_t)k * (size_t)N + (size_t)n]);
  }
  partial[(size_t)blockIdx.y * (size_t)N + (size_t)n] = m;
}

__global__ void __launch_bounds__(kColThreads)
shift_finish(const float* __restrict__ partial, int k_blocks, int64_t N,
             float* __restrict__ m_out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = -INFINITY;
  for (int b = 0; b < k_blocks; ++b) m = fmaxf(m, partial[(size_t)b * (size_t)N + (size_t)n]);
  m_out[n] = m;
}

__global__ void __launch_bounds__(kColThreads)
denom_partials(const float* __restrict__ uh, const float* __restrict__ ul,
               const float* __restrict__ gh, const float* __restrict__ gl,
               const float* __restrict__ m, int K, int64_t N, int rows_per_block,
               double* __restrict__ partial) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int k0 = blockIdx.y * rows_per_block;
  const int k1 = (k0 + rows_per_block < K) ? k0 + rows_per_block : K;
  const double mn = (double)m[n];
  double s = 0.0;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const size_t idx = (size_t)k * (size_t)N + (size_t)n;
    const double a = ((double)__ldg(gh + k) + (double)__ldg(gl + k)) -
                     ((double)uh[idx] + (double)ul[idx]);
    s += exp(a - mn);
  }
  partial[(size_t)blockIdx.y * (size_t)N + (size_t)n] = s;
}

__global__ void __launch_bounds__(kColThreads)
denom_finish(const double* __restrict__ partial, int k_blocks, int64_t N,
             float* __restrict__ s_hi, float* __restrict__ s_lo) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  double s = 0.0;
  for (int b = 0; b < k_blocks; ++b) s += partial[(size_t)b * (size_t)N + (size_t)n];
  const float hi = (float)s;
  s_hi[n] = hi;
  s_lo[n] = (float)(s - (double)hi);
}

__global__ void __launch_bounds__(kColThreads)
denom_recip(const float* __restrict__ m, const float* __restrict__ dh,
            const float* __restrict__ dl, const float* __restrict__ c, int64_t N,
            double* __restrict__ m64, double* __restrict__ r) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const double d = (double)dh[n] + (double)dl[n];
  double rn = (d > 0.0) ? 1.0 / d : 0.0;  // d <= 0 (and NaN): the column adds 0
  if (c != nullptr) rn *= (double)c[n];
  m64[n] = (double)m[n];
  r[n] = rn;
}

// The (column blocks, k blocks) grid of the column kernels; false when it
// does not fit.  k_blocks is cut so that no k block is empty.
bool column_grid(int K, int64_t N, int k_blocks_wanted, dim3* grid, int* rows_per_block) {
  if (K <= 0 || N <= 0 || k_blocks_wanted <= 0 || k_blocks_wanted > 65535) return false;
  const int64_t col_blocks = (N + kColThreads - 1) / kColThreads;
  if (col_blocks > 2147483647LL) return false;
  *rows_per_block = (K + k_blocks_wanted - 1) / k_blocks_wanted;
  const int k_blocks = (K + *rows_per_block - 1) / *rows_per_block;
  *grid = dim3((unsigned)col_blocks, (unsigned)k_blocks);
  return true;
}

}  // namespace

// Each launcher runs its kernels on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it cannot take).  The caller allocates
// every output and scratch buffer; `partial` holds k_blocks x N values.

// m_out (N,) float32 = max_k (gh_k - uh_kn); partial: k_blocks x N float32.
extern "C" int column_shift_launch(const float* uh, const float* gh, int K, int64_t N,
                                   int k_blocks, float* partial, float* m_out,
                                   void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid;
  int rows;
  if (!column_grid(K, N, k_blocks, &grid, &rows)) return (int)cudaErrorInvalidValue;
  shift_partials<<<grid, kColThreads, 0, st>>>(uh, gh, K, N, rows, partial);
  shift_finish<<<grid.x, kColThreads, 0, st>>>(partial, (int)grid.y, N, m_out);
  return (int)cudaGetLastError();
}

// K3: (s_hi, s_lo) (N,) float32 = sum_k exp(a_kn - m_n); partial: k_blocks x N float64.
extern "C" int denom_sums_launch(const float* uh, const float* ul, const float* gh,
                                 const float* gl, const float* m, int K, int64_t N,
                                 int k_blocks, double* partial, float* s_hi,
                                 float* s_lo, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid;
  int rows;
  if (!column_grid(K, N, k_blocks, &grid, &rows)) return (int)cudaErrorInvalidValue;
  denom_partials<<<grid, kColThreads, 0, st>>>(uh, ul, gh, gl, m, K, N, rows, partial);
  denom_finish<<<grid.x, kColThreads, 0, st>>>(partial, (int)grid.y, N, s_hi, s_lo);
  return (int)cudaGetLastError();
}

// K4: (s_hi, s_lo) (K,) float32 = sum_n c_n exp(a_kn - m_n) / d_n; m64 and
// r are (N,) float64 scratch, partial (n_split, K) float64; c may be null.
extern "C" int wsum_denom_launch(const float* uh, const float* ul, const float* gh,
                                 const float* gl, const float* m, const float* dh,
                                 const float* dl, const float* c, int K, int64_t N,
                                 int n_split, double* m64, double* r, double* partial,
                                 float* s_hi, float* s_lo, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (K <= 0 || N <= 0 || n_split <= 0 || n_split > 65535) return (int)cudaErrorInvalidValue;
  const int64_t col_blocks = (N + kColThreads - 1) / kColThreads;
  if (col_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  denom_recip<<<(unsigned)col_blocks, kColThreads, 0, st>>>(m, dh, dl, c, N, m64, r);
  return (int)launch_rows_and_finish(uh, ul, gh, gl, m64, r, K, N, n_split, partial, s_hi, s_lo,
                                     st);
}
