// The weight-sum row pass and its finish, shared by wsum.cu (K1 wsum_dd)
// and wsum_split.cu (K4 wsum_denom_dd): given per-column f64 shifts m_n and
// reciprocal weights r_n, S_k = sum_n exp((g_k - u_kn) - m_n) r_n.
//
//   wsum_rows: grid (k tiles of kRowsPerBlock rows, n splits); each thread
//     walks its columns once for all rows of the tile (m_n and r_n loaded
//     once per column), accumulates in f64 registers, and the block reduces
//     with warp shuffles into partial[split, k].  Columns with r_n == 0
//     (pad columns, zero counts) add exactly 0.
//   wsum_finish: sums the partials over the splits in a fixed order and
//     splits S into hi/lo float32.  No atomics: the same bits on every run.
//
// kPinned = false is production; kPinned = true is the roofline probe of
// roofline.cu, where virtual column n reads column n & (tile - 1) of one
// (K, tile) pair (see wsum_columns.cuh).  The production instantiation
// compiles the index expression the row pass always had.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kRowThreads = 256;
constexpr int kFinishThreads = 256;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <bool kPinned>
__global__ void __launch_bounds__(kRowThreads)
wsum_rows(const float* __restrict__ uh, const float* __restrict__ ul,
          const float* __restrict__ gh, const float* __restrict__ gl,
          const double* __restrict__ m, const double* __restrict__ r,
          int K, int64_t N, int64_t cols_per_split, int64_t tile,
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
    const int64_t col = kPinned ? (n & (tile - 1)) : n;
    const int64_t ld = kPinned ? tile : N;
#pragma unroll
    for (int j = 0; j < kRowsPerBlock; ++j) {
      const int k = k0 + j;
      if (k < K) {
        const size_t idx = (size_t)k * (size_t)ld + (size_t)col;
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

// Launches wsum_rows then wsum_finish on `st`: n_split column splits,
// partial ((n_split, K) float64) and the (K,) float32 outputs allocated by
// the caller; `tile` is read only by the pinned probe.
template <bool kPinned = false>
inline void launch_rows_and_finish(const float* uh, const float* ul, const float* gh,
                                   const float* gl, const double* m, const double* r,
                                   int K, int64_t N, int n_split, double* partial,
                                   float* s_hi, float* s_lo, cudaStream_t st,
                                   int64_t tile = 0) {
  const int64_t cols_per_split = (N + n_split - 1) / n_split;
  const dim3 grid((K + kRowsPerBlock - 1) / kRowsPerBlock, n_split);
  wsum_rows<kPinned><<<grid, kRowThreads, 0, st>>>(uh, ul, gh, gl, m, r, K, N, cols_per_split,
                                                   tile, partial);
  wsum_finish<<<(K + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0, st>>>(
      partial, K, n_split, s_hi, s_lo);
}

}  // namespace
