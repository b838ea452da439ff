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
// artefacts: ragged edges are bounds checks, and plane indices are 64-bit
// (K N > 2^31 at the flagship).
//
// What bounds them on the H100: bytes.  Each reads both planes once by the
// contract, 8 B/element, 8.2 GB at the 1024 x 999424 flagship: 2.44 ms at
// 3.35 TB/s.
//
// K5 reads the planes once, as the TPU kernel does ("the u planes stream
// once"): it is the second instantiation (kLognum) of K1's single-read
// cluster kernel (wsum_fused.cuh), then lognum_fused_finish.  The identity:
// for a finite g_k, K5's term is
//   exp((-m_k - u_kn) - ld_n) = T_kn r_n F_k,
//   T_kn = exp(a_kn - m_n)  (K1's, in registers, summed into s_n),
//   r_n = exp(m_n - ld_n)   (per column, with ld_n = log s_n + m_n rounded
//                            to its (hi, lo) pair; 0 on pad columns),
//   F_k = exp(-(g_k + m_k)) (per row, in the finish).
// So the kernel accumulates A_k = sum_n T_kn r_n exactly as K1 accumulates
// sum_n T_kn c_n / s_n, with one f64 exp per element, and the finish forms
// s_k = A_k F_k, or log s_k + m_k = log A_k - g_k (A_k = 0 gives 0 and
// -inf, never 0 * inf).  Its time is K1's: the planes stream at the rate
// of the cluster kernel's per-tile instruction stream (barriers, cluster
// exchanges, reductions; wsum_fused.cuh), and one log and one exp per
// column and warp replace K1's division.  In clusters of 8 and 16 blocks
// (K > 2048) that column work and the direct-form branch lengthen the
// path between cluster barriers, and K5 takes longer than K1 (PERF.md;
// profiling/torch_k5_variants.py).
//
// Rows the factorization cannot take: the split exponents a_kn - m_n and
// g_k + m_k are of the size of |g_k + m_k| + ln K, where K7's own exponent
// is of order 1, so each term of a factorized row carries an extra relative
// rounding of up to ~(|g_k + m_k| + ln K) 2^-52.  Rows with
// |g_k + m_k| <= kLognumDirectShift = 64 keep it below (64 + ln 8192)
// 2^-52 = 1.6e-14, a sixth of the contract's 1e-13.  The same bound keeps
// F_k within e^(+-64), so it neither overflows nor underflows, and a T_kn
// that underflows (a_kn - m_n < -745) stands for a term below e^-681,
// far below 2^-149, the finest step of the float32 pair (at 1e-13 relative
// the pair holds no s_k below ~1e-32).  Every other row -- g_k far below
// the column maxima (its T_kn underflow while its terms do not), the
// -1e10 sentinel g over real u (a clash-level row, which the contract
// keeps), m_k far from the row's lognum -- takes the direct form:
// lognum_direct_row decides once per launch from g_k and m_k, the block
// keeps a flag per row in shared memory, and in a block with such a row
// their T_kn register takes exp((-m_k - u_kn) - m_n) after T_kn entered
// s_n, so r_n completes their term and the finish takes A_k as s_k.  A
// polish iteration pays none of this: there m_k ~ -f_k and g_k = f_k +
// ln N_k, so g_k + m_k ~ ln N_k.
//
// K5 takes K <= 8192, the cluster kernel's limit (clusters of up to 16
// blocks of 512 rows); the wrapper raises above it.
//
// Design of K6 and K7, no atomics (the same bits on every run):
//   logden_columns (K6): one thread per column, threads across n so every
//     row load is coalesced; an online sum rescaled whenever the float32
//     max rises, so the final shift is the contract's m_n and each element
//     costs one exp.
//   lognum_prep (K7's first step): ld_n into f64 and r_n = 1.
//   wsum_rows (wsum_rows.cuh, the shared row pass: 32-row blocks over
//     128-column tiles of both planes staged by cp.async in a 3-stage ring)
//     with g = (-m_k, 0), the f64 ld as the column shift and r_n as the
//     column weight, then lognum_finish: the per-split partials summed in a
//     fixed order, log + m_k, split into (hi, lo).
// K6 followed by K7 on K5's masked ld gives K5's sums to rounding.

#include "wsum_fused.cuh"

namespace {

constexpr int kColThreads = 256;

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

// K7's finish: the per-split partials in a fixed order, log + m_k.
__global__ void __launch_bounds__(kFinishThreads)
lognum_finish(const double* __restrict__ partial, int K, int n_split,
              const float* __restrict__ m_k, float* __restrict__ out_hi,
              float* __restrict__ out_lo) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  double S = 0.0;
  for (int i = 0; i < n_split; ++i) S += partial[(size_t)i * (size_t)K + (size_t)k];
  const double v = log(S) + (double)m_k[k];
  const float hi = (float)v;
  out_hi[k] = hi;
  out_lo[k] = (float)(v - (double)hi);
}

// K5's finish: A_k, the per-cluster partials in a fixed order, then s_k =
// A_k exp(-(g_k + m_k)) or log s_k + m_k = log A_k - g_k; a direct-form row
// holds s_k itself.
__global__ void __launch_bounds__(kFinishThreads)
lognum_fused_finish(const double* __restrict__ partial, int K, int n_clusters,
                    const float* __restrict__ gh, const float* __restrict__ gl,
                    const float* __restrict__ m_k, int take_log, float* __restrict__ out_hi,
                    float* __restrict__ out_lo) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  double A = 0.0;
  for (int i = 0; i < n_clusters; ++i) A += partial[(size_t)i * (size_t)K + (size_t)k];
  const double g = (double)gh[k] + (double)gl[k];  // as the kernel's gs
  const double mk = (double)m_k[k];
  double v;
  if (lognum_direct_row(g, mk))
    v = take_log ? log(A) + mk : A;
  else
    v = take_log ? log(A) - g : A * exp(-(g + mk));
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

}  // namespace

// Each launcher runs its kernels on `stream` and returns cudaGetLastError()
// (or the launch API's error; cudaErrorInvalidValue for a shape it cannot
// take).  The caller allocates every output and scratch buffer.

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

// K7: (out_hi, out_lo) (K,) float32 = log sum_n exp((-m_k - u_kn) - ld_n) +
// m_k; scratch ld64 and r (N,) float64, g_hi and g_lo (K,) float32, partial
// (n_split, K) float64.
extern "C" int lognum_launch(const float* uh, const float* ul, const float* ld_hi,
                             const float* ld_lo, const float* m_k, int K, int64_t N,
                             int n_split, double* ld64, double* r, float* g_hi, float* g_lo,
                             double* partial, float* out_hi, float* out_lo, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  unsigned blocks;
  if (!column_blocks(K, N, &blocks) || n_split <= 0 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const unsigned k_blocks = (unsigned)((K + kFinishThreads - 1) / kFinishThreads);
  lognum_prep<<<blocks, kColThreads, 0, st>>>(ld_hi, ld_lo, N, ld64, r);
  row_shift<<<k_blocks, kFinishThreads, 0, st>>>(m_k, K, g_hi, g_lo);
  const cudaError_t e = launch_rows(uh, ul, g_hi, g_lo, ld64, r, K, N, n_split, partial, st);
  if (e != cudaSuccess) return (int)e;
  lognum_finish<<<k_blocks, kFinishThreads, 0, st>>>(partial, K, n_split, m_k, out_hi, out_lo);
  return (int)cudaGetLastError();
}

// K5: (out_hi, out_lo) (K,) float32, the sums s_k (return_sums != 0) or
// log s_k + m_k; partial (max_clusters, K) float64, max_clusters from
// wsum_fused_clusters (wsum.cu).
extern "C" int lognum_fused_launch(const float* uh, const float* ul, const float* gh,
                                   const float* gl, const float* m_k, int K, int64_t N,
                                   int max_clusters, int return_sums, double* partial,
                                   float* out_hi, float* out_lo, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int n_clusters = 0;
  const cudaError_t e = launch_fused<false, true>(uh, ul, gh, gl, nullptr, m_k, K, N,
                                                  max_clusters, partial, st, 0, &n_clusters);
  if (e != cudaSuccess) return (int)e;
  lognum_fused_finish<<<(K + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0, st>>>(
      partial, K, n_clusters, gh, gl, m_k, return_sums ? 0 : 1, out_hi, out_lo);
  return (int)cudaGetLastError();
}
