// wsum_dd for Hopper (sm_90a): S_k = sum_n c_n N_k W_nk from the (hi, lo)
// float32 planes of the preconditioned reduced potentials u_kn.
//
// Replaces the TPU kernel `_wsum_kernel` (pymbar_tpu/ops/pallas_kernels.py:584)
// and, since it has no cap on K, also the role of `_wsum_big_kernel` (:476).
// Contract, as there: with a_kn = g_k - u_kn (g = f + ln N_k, both given as
// dd pairs), m_n = max_k a_kn, T_kn = exp(a_kn - m_n), s_n = sum_k T_kn and
// r_n = c_n / s_n (c = 1 when absent), S_k = sum_n T_kn r_n.  A column is
// padding (r_n = 0) only when max_k(g_hi_k - u_hi_kn) < -1e8, i.e. when every
// row holds the +1e10 sentinel; one clash-level row does not make a pad.
//
// The TPU has no FP64, so the Pallas kernel chains error-free f32 transforms
// (double-word arithmetic).  The H100 has native FP64: every value here is
// rebuilt as hi + lo in double and all arithmetic is plain f64, so FMA
// contraction is harmless.
//
// What bounds it on the H100: the kernel reads both f32 planes twice
// (16 B per element, 16.4 GB for the 1024 x 999424 flagship, ~4.9 ms at
// 3.35 TB/s) and evaluates two f64 exps per element (~2e9 x ~20 DFMA, ~2.5 ms
// at the FP64 pipe's ~16.7 TFMA/s), so it is memory-bound with the FP64 pipe
// close behind.  Design: three launches, no atomics, deterministic.
//   1. wsum_columns: one thread per column, threads across n so every row
//      load is coalesced; an online max with a rescaled sum gives m_n and
//      s_n with one exp per element; writes m_n and r_n (f64 scratch).
//   2. wsum_rows: grid (k tiles of kRowsPerBlock rows, n splits); each thread
//      walks its columns once for all rows of the tile (m_n and r_n loaded
//      once per column), accumulates T_kn r_n in f64 registers, and the
//      block reduces with warp shuffles into partial[split, k].
//   3. wsum_finish: sums the partials over the splits in a fixed order and
//      splits S into hi/lo float32.
// Recomputing T in pass 2 costs one more read of the planes (8 B/element)
// where storing it would cost a write and a read (16 B/element in f64).
// One read with T kept on chip (TMA tiles) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kColThreads = 256;
constexpr int kRowsPerBlock = 8;
constexpr int kRowThreads = 256;
constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kColThreads)
wsum_columns(const float* __restrict__ uh, const float* __restrict__ ul,
             const float* __restrict__ gh, const float* __restrict__ gl,
             const float* __restrict__ c, int K, int64_t N,
             double* __restrict__ m_out, double* __restrict__ r_out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  double m = -INFINITY;
  double s = 0.0;
  float m_hi = -INFINITY;  // the pad test uses the hi words, as on the TPU
  for (int k = 0; k < K; ++k) {
    const size_t idx = (size_t)k * (size_t)N + (size_t)n;
    const float h = uh[idx];
    const float gk = __ldg(gh + k);
    const double a = ((double)gk + (double)__ldg(gl + k)) - ((double)h + (double)ul[idx]);
    m_hi = fmaxf(m_hi, gk - h);
    if (a > m) {
      s = s * exp(m - a) + 1.0;
      m = a;
    } else {
      s += exp(a - m);
    }
  }
  double r = (m_hi < -1.0e8f) ? 0.0 : 1.0 / s;
  if (c != nullptr) r *= (double)c[n];
  m_out[n] = m;
  r_out[n] = r;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kRowThreads)
wsum_rows(const float* __restrict__ uh, const float* __restrict__ ul,
          const float* __restrict__ gh, const float* __restrict__ gl,
          const double* __restrict__ m, const double* __restrict__ r,
          int K, int64_t N, int64_t cols_per_split,
          double* __restrict__ partial) {
  const int k0 = blockIdx.x * kRowsPerBlock;
  const int split = blockIdx.y;
  const int64_t n0 = (int64_t)split * cols_per_split;
  const int64_t n1 = (n0 + cols_per_split < N) ? n0 + cols_per_split : N;

  double g[kRowsPerBlock];
  double acc[kRowsPerBlock];
#pragma unroll
  for (int j = 0; j < kRowsPerBlock; ++j) {
    const int k = k0 + j;
    g[j] = (k < K) ? (double)gh[k] + (double)gl[k] : 0.0;
    acc[j] = 0.0;
  }

  for (int64_t n = n0 + threadIdx.x; n < n1; n += blockDim.x) {
    const double rn = r[n];
    if (rn == 0.0) continue;  // pad columns (and zero counts) add exactly 0
    const double mn = m[n];
#pragma unroll
    for (int j = 0; j < kRowsPerBlock; ++j) {
      const int k = k0 + j;
      if (k < K) {
        const size_t idx = (size_t)k * (size_t)N + (size_t)n;
        const double a = g[j] - ((double)uh[idx] + (double)ul[idx]);
        acc[j] += exp(a - mn) * rn;
      }
    }
  }

  __shared__ double red[kRowsPerBlock][kRowThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kRowsPerBlock; ++j) {
    const double v = warp_sum(acc[j]);
    if (lane == 0) red[j][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kRowsPerBlock) {
    const int j = threadIdx.x;
    const int k = k0 + j;
    if (k < K) {
      double v = 0.0;
      for (int w = 0; w < kRowThreads / 32; ++w) v += red[j][w];
      partial[(size_t)split * (size_t)K + (size_t)k] = v;
    }
  }
}

__global__ void __launch_bounds__(kFinishThreads)
wsum_finish(const double* __restrict__ partial, int K, int n_split,
            float* __restrict__ s_hi, float* __restrict__ s_lo) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  double S = 0.0;
  for (int i = 0; i < n_split; ++i) S += partial[(size_t)i * (size_t)K + (size_t)k];
  const float hi = (float)S;
  s_hi[k] = hi;
  s_lo[k] = (float)(S - (double)hi);
}

}  // namespace

// Launches the three kernels on `stream` and returns cudaGetLastError().
// The caller allocates m and r ((N,) float64), partial ((n_split, K)
// float64) and the (K,) float32 outputs; c may be null.
extern "C" int wsum_dd_launch(const float* uh, const float* ul, const float* gh,
                              const float* gl, const float* c, int K, int64_t N,
                              int n_split, double* m, double* r, double* partial,
                              float* s_hi, float* s_lo, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (K <= 0 || N <= 0 || n_split <= 0) return (int)cudaErrorInvalidValue;
  const int64_t col_blocks = (N + kColThreads - 1) / kColThreads;
  if (col_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  wsum_columns<<<(unsigned)col_blocks, kColThreads, 0, st>>>(uh, ul, gh, gl, c, K, N, m, r);

  const int64_t cols_per_split = (N + n_split - 1) / n_split;
  const dim3 grid((K + kRowsPerBlock - 1) / kRowsPerBlock, n_split);
  wsum_rows<<<grid, kRowThreads, 0, st>>>(uh, ul, gh, gl, m, r, K, N, cols_per_split, partial);

  wsum_finish<<<(K + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0, st>>>(
      partial, K, n_split, s_hi, s_lo);
  return (int)cudaGetLastError();
}
