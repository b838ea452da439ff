// The lognum family for Hopper (sm_90a): K6 logden_dd, K7 lognum_dd and
// their fusion K5 lognum_fused_dd, from the (hi, lo) float32 planes of the
// reduced potentials u_kn.
//
// Replaces the TPU kernels `_logden_kernel` (K6,
// pymbar_tpu/ops/pallas_kernels.py:189, called by `logden_dd` :210),
// `_lognum_kernel` (K7, :261, called by `lognum_dd` :285) and
// `_fused_polish_kernel` (K5, :331, called by `lognum_fused_dd` :383).
// Contracts, as there, with a_kn = g_k - u_kn rebuilt in f64 from the dd
// planes and m_n = max_k (g_hi_k - u_hi_kn) in float32 (hi words only):
//   K6:  ld_n = log sum_k exp(a_kn - m_n) + m_n, split into (hi, lo); no pad
//        masking (an all-sentinel column gives ld ~ -1e10).
//   K7:  ln_k = log sum_n exp((-m_k - u_kn) - ld_n) + m_k with the caller's
//        float32 shift m_k and ld = ld_hi + ld_lo; no masking, so a
//        sentinel column fed K6's ld adds its phantom exp(-m_k)-sized term.
//   K5:  K6's ld, rounded to the (hi, lo) pair K7 would read, then the pad
//        rule (m_n < -1e8: the column adds exactly 0), then K7's sums; the
//        raw sums s_k (return_sums) or log s_k + m_k.
// Every value is rebuilt as hi + lo in double and the arithmetic is plain
// f64 (the H100 has FP64; the TPU's double-word chains are not needed).  K
// padding to a power of two, N to a tile and the K <= 2048 cap are TPU
// artefacts: any K and N are taken, ragged edges are bounds checks, and
// plane indices are 64-bit (K N > 2^31 at the flagship).
//
// What bounds them on the H100: bytes.  Each reads both planes once by the
// contract, 8 B/element, 8.2 GB at the 1024 x 999424 flagship: 2.44 ms at
// 3.35 TB/s.  One f64 exp per element per pass (~1e9 x ~20 FP64
// instructions, ~1.2 ms at ~34 TFLOP/s) stays below that.
// Design, no atomics (the same bits on every run):
//   logden_columns (K6) / fused_columns (K5's first half): one thread per
//     column, threads across n so every row load is coalesced; an online
//     sum rescaled whenever the float32 max rises, so the final shift is the
//     contract's m_n and each element costs one exp.
//   lognum_prep (K7's first step): ld_n into f64 and r_n = 1.
//   wsum_rows (wsum_rows.cuh, the shared row pass: 32-row blocks over
//     128-column tiles of both planes staged by cp.async in a 3-stage ring)
//     with g = (-m_k, 0), the f64 ld as the column shift and r_n as the
//     column weight (0 on K5's pad columns, which the row pass skips), then
//     lognum_finish: the per-split partials summed in a fixed order,
//     optionally log + m_k, split into (hi, lo).
// So K5 reads the planes twice (16.4 GB, a 4.9 ms floor at the flagship)
// and K7 once after its prep.  K1's single-read cluster kernel
// (wsum_fused.cuh) shows the way to one read for K5: its column pass is
// K1's with a log, and its row pass needs the ld of the whole column,
// which the cluster already shares.  K6 followed by K7 on K5's masked ld
// gives K5's bits.

#include "wsum_rows.cuh"

namespace {

constexpr int kColThreads = 256;
constexpr float kPadShift = -1.0e8f;

// ld_n of one column (f64) and its float32 shift m_n.
__device__ __forceinline__ double column_logden(const float* __restrict__ uh,
                                                const float* __restrict__ ul,
                                                const float* __restrict__ gh,
                                                const float* __restrict__ gl, int K,
                                                int64_t N, int64_t n, float* m_out) {
  float m = -INFINITY;
  double s = 0.0;
  for (int k = 0; k < K; ++k) {
    const size_t idx = (size_t)k * (size_t)N + (size_t)n;
    const float h = uh[idx];
    const float gk = __ldg(gh + k);
    const double a = ((double)gk + (double)__ldg(gl + k)) - ((double)h + (double)ul[idx]);
    const float d = gk - h;
    if (d > m) {
      s *= exp((double)m - (double)d);  // 0 on the first row (m = -inf)
      m = d;
    }
    s += exp(a - (double)m);
  }
  *m_out = m;
  return log(s) + (double)m;
}

__global__ void __launch_bounds__(kColThreads)
logden_columns(const float* __restrict__ uh, const float* __restrict__ ul,
               const float* __restrict__ gh, const float* __restrict__ gl, int K,
               int64_t N, float* __restrict__ ld_hi, float* __restrict__ ld_lo) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m;
  const double ld = column_logden(uh, ul, gh, gl, K, N, n, &m);
  const float hi = (float)ld;
  ld_hi[n] = hi;
  ld_lo[n] = (float)(ld - (double)hi);
}

__global__ void __launch_bounds__(kColThreads)
fused_columns(const float* __restrict__ uh, const float* __restrict__ ul,
              const float* __restrict__ gh, const float* __restrict__ gl, int K,
              int64_t N, double* __restrict__ ld64, double* __restrict__ r) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m;
  const double ld = column_logden(uh, ul, gh, gl, K, N, n, &m);
  const float hi = (float)ld;
  const float lo = (float)(ld - (double)hi);
  ld64[n] = (double)hi + (double)lo;  // the pair K6 writes and K7 reads
  r[n] = (m < kPadShift) ? 0.0 : 1.0;
}

__global__ void __launch_bounds__(kColThreads)
lognum_prep(const float* __restrict__ ld_hi, const float* __restrict__ ld_lo, int64_t N,
            double* __restrict__ ld64, double* __restrict__ r) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  ld64[n] = (double)ld_hi[n] + (double)ld_lo[n];
  r[n] = 1.0;
}

// The row pass's g = (-m_k, 0): exp((g_k - u_kn) - ld_n) is K7's term.
__global__ void __launch_bounds__(kFinishThreads)
row_shift(const float* __restrict__ m_k, int K, float* __restrict__ g_hi,
          float* __restrict__ g_lo) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  g_hi[k] = -m_k[k];
  g_lo[k] = 0.0f;
}

__global__ void __launch_bounds__(kFinishThreads)
lognum_finish(const double* __restrict__ partial, int K, int n_split,
              const float* __restrict__ m_k, int take_log, float* __restrict__ out_hi,
              float* __restrict__ out_lo) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  double S = 0.0;
  for (int i = 0; i < n_split; ++i) S += partial[(size_t)i * (size_t)K + (size_t)k];
  const double v = take_log ? log(S) + (double)m_k[k] : S;
  const float hi = (float)v;
  out_hi[k] = hi;
  out_lo[k] = (float)(v - (double)hi);
}

bool column_blocks(int K, int64_t N, unsigned* blocks) {
  if (K <= 0 || N <= 0) return false;
  const int64_t b = (N + kColThreads - 1) / kColThreads;
  if (b > 2147483647LL) return false;
  *blocks = (unsigned)b;
  return true;
}

// wsum_rows over (g_hi, g_lo) = (-m_k, 0) with the f64 shifts ld64 and the
// weights r, then lognum_finish.
int rows_and_finish(const float* uh, const float* ul, const float* m_k, const double* ld64,
                    const double* r, int K, int64_t N, int n_split, float* g_hi,
                    float* g_lo, double* partial, int take_log, float* out_hi,
                    float* out_lo, cudaStream_t st) {
  if (n_split <= 0 || n_split > 65535) return (int)cudaErrorInvalidValue;
  const unsigned k_blocks = (unsigned)((K + kFinishThreads - 1) / kFinishThreads);
  row_shift<<<k_blocks, kFinishThreads, 0, st>>>(m_k, K, g_hi, g_lo);
  const cudaError_t e = launch_rows(uh, ul, g_hi, g_lo, ld64, r, K, N, n_split, partial, st);
  if (e != cudaSuccess) return (int)e;
  lognum_finish<<<k_blocks, kFinishThreads, 0, st>>>(partial, K, n_split, m_k, take_log,
                                                     out_hi, out_lo);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher runs its kernels on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it cannot take).  The caller allocates
// every output and scratch buffer: ld64 and r (N,) float64, g_hi and g_lo
// (K,) float32, partial (n_split, K) float64.

// K6: (ld_hi, ld_lo) (N,) float32.
extern "C" int logden_launch(const float* uh, const float* ul, const float* gh,
                             const float* gl, int K, int64_t N, float* ld_hi, float* ld_lo,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  unsigned blocks;
  if (!column_blocks(K, N, &blocks)) return (int)cudaErrorInvalidValue;
  logden_columns<<<blocks, kColThreads, 0, st>>>(uh, ul, gh, gl, K, N, ld_hi, ld_lo);
  return (int)cudaGetLastError();
}

// K7: (out_hi, out_lo) (K,) float32 = log sum_n exp((-m_k - u_kn) - ld_n) + m_k.
extern "C" int lognum_launch(const float* uh, const float* ul, const float* ld_hi,
                             const float* ld_lo, const float* m_k, int K, int64_t N,
                             int n_split, double* ld64, double* r, float* g_hi, float* g_lo,
                             double* partial, float* out_hi, float* out_lo, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  unsigned blocks;
  if (!column_blocks(K, N, &blocks)) return (int)cudaErrorInvalidValue;
  lognum_prep<<<blocks, kColThreads, 0, st>>>(ld_hi, ld_lo, N, ld64, r);
  return rows_and_finish(uh, ul, m_k, ld64, r, K, N, n_split, g_hi, g_lo, partial, 1,
                         out_hi, out_lo, st);
}

// K5: (out_hi, out_lo) (K,) float32, the sums s_k (return_sums != 0) or
// log s_k + m_k.
extern "C" int lognum_fused_launch(const float* uh, const float* ul, const float* gh,
                                   const float* gl, const float* m_k, int K, int64_t N,
                                   int n_split, int return_sums, double* ld64, double* r,
                                   float* g_hi, float* g_lo, double* partial, float* out_hi,
                                   float* out_lo, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  unsigned blocks;
  if (!column_blocks(K, N, &blocks)) return (int)cudaErrorInvalidValue;
  fused_columns<<<blocks, kColThreads, 0, st>>>(uh, ul, gh, gl, K, N, ld64, r);
  return rows_and_finish(uh, ul, m_k, ld64, r, K, N, n_split, g_hi, g_lo, partial,
                         return_sums ? 0 : 1, out_hi, out_lo, st);
}
