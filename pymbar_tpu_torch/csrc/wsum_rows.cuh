// The weight-sum row pass and its finish, shared by wsum_split.cu (K4
// wsum_denom_dd) and lognum.cu (K7, K5's second half): given per-column f64
// shifts m_n and weights r_n, S_k = sum_n exp((g_k - u_kn) - m_n) r_n.  K1's
// fused kernel (wsum_fused.cuh) takes its exp, its cp.async staging and its
// finish from here.
//
// What bounds it on the H100: bytes.  Each element of both f32 planes is
// read once (8 B) and costs one f64 exp (~21 FP64 FMA slots at the
// measured 0.79e12 exps/s), so at the 8192 x 327680 slice the 21.5 GB take
// 6.4 ms at 3.35 TB/s and the 2.7e9 exps ~3.4 ms: the memory system and the
// FP64 pipe must both stay busy at once.
//
// Design:
//   exp_tab: the exp of every element, a table-driven branch-free f64 exp
//     (~14 FP64 instructions where the libm exp takes ~21 FMA slots); the
//     K8b probe showed the kernels limited by their instructions, not HBM.
//   wsum_rows: grid (k tiles of kRowsPerBlock = 32 rows, n splits), 256
//     threads, two blocks per SM.  Each block walks its split in column
//     tiles of kRowTileCols = 128 and stages every tile -- both planes
//     (32 x 128 x 8 B) and the tile's m_n, r_n (2 KB) -- into shared memory
//     through a ring of kRowStages = 3 stages filled by cp.async (16-byte
//     copies; 4-byte ones when N is not a multiple of 4).  Two tiles are
//     always in flight while the third is computed, and no thread waits on
//     a load it started for its own arithmetic.  Thread t owns column
//     t % 128 of the tile and 16 rows, so m_n and r_n come from shared
//     memory once per column and tile for 16 rows, and a warp reads 32
//     consecutive words of one row (no bank conflicts).  The f64 row sums
//     stay in registers across the whole split; at the end each row is
//     reduced with warp shuffles and a fixed-order sum over the 4 warps of
//     its row group into partial[split, k].
//     Columns with r_n == 0 (pad columns, zero counts, K4's d_n <= 0) are
//     skipped by a branch, so they add exactly 0 even where their exp
//     would overflow; a tile whose columns all have r_n == 0 is skipped
//     whole (__syncthreads_or).
//   wsum_finish: sums the partials over the splits in a fixed order and
//     splits S into hi/lo float32.  No atomics: the same bits on every run.
//
// stage_planes<kPinned = true> serves the roofline probe of roofline.cu
// (through wsum_fused.cuh), where virtual column n reads column
// n & (tile - 1) of one (K, tile) pair; kPinned = false compiles the
// production index expression.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 32;
constexpr int kRowThreads = 256;
constexpr int kRowTileCols = 128;
constexpr int kRowStages = 3;
constexpr int kRowGroups = kRowThreads / kRowTileCols;        // 2
constexpr int kRowsPerThread = kRowsPerBlock / kRowGroups;    // 16
constexpr int kRowPlaneBytes = kRowsPerBlock * kRowTileCols * 4;
constexpr int kRowStageBytes = 2 * kRowPlaneBytes + 2 * kRowTileCols * 8;
constexpr int kExpTableBytes = 64 * 8;
constexpr int kRowSmemBytes = kRowStages * kRowStageBytes + kExpTableBytes;  // 104,960
constexpr int kFinishThreads = 256;

// 2^(j/64), j = 0..63, into tab (shared memory) by the first 64 threads;
// the caller synchronises before exp_tab reads it.
__device__ __forceinline__ void exp_table_init(double* tab) {
  if (threadIdx.x < 64) tab[threadIdx.x] = exp2((double)threadIdx.x / 64.0);
}

// exp(x) in f64 without branches, within an ulp of exp() (1e-13 holds
// with room): x = (k + j/64) ln2 + r with |r| <= ln2/128, exp(x) =
// 2^k 2^(j/64) e^r, e^r - 1 by a degree-5 polynomial (truncation ~3e-17),
// 2^k applied as two exact power-of-two factors so that the result
// underflows to 0 and overflows to inf as exp() does.  x is clamped to
// [-1400, 800] (exp(-inf) stays 0; NaN passes through).  About 14 FP64
// instructions where exp() takes ~21 FMA slots.
__device__ __forceinline__ double exp_tab(double x, const double* __restrict__ tab) {
  constexpr double kShifter = 6755399441055744.0;  // 1.5 * 2^52
  constexpr double kInvLn2x64 = 92.33248261689366;
  constexpr double kLn2d64Hi = 0.010830424696223417;  // 36 bits: kf * hi is exact
  constexpr double kLn2d64Lo = 2.572804622327669e-14;
  x = x < -1400.0 ? -1400.0 : x;
  x = x > 800.0 ? 800.0 : x;
  const double t = fma(x, kInvLn2x64, kShifter);
  const int n = __double2loint(t);
  const double kf = t - kShifter;
  double r = fma(kf, -kLn2d64Hi, x);
  r = fma(kf, -kLn2d64Lo, r);
  double q = fma(r, 1.0 / 120.0, 1.0 / 24.0);
  q = fma(r, q, 1.0 / 6.0);
  q = fma(r, q, 0.5);
  q = fma(r, q, 1.0);
  q *= r;
  const double tj = tab[n & 63];
  const double p = fma(tj, q, tj);
  const int k = n >> 6;
  const int k1 = k >> 1;
  return p * __hiloint2double((k1 + 1023) << 20, 0) *
         __hiloint2double((k - k1 + 1023) << 20, 0);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// cp.async of 16 (cg) or 4 (ca) bytes; src_bytes < size zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Plane column of virtual column n: n itself, or n & (tile - 1) pinned.
template <bool kPinned>
__device__ __forceinline__ int64_t plane_col(int64_t n, int64_t tile) {
  return kPinned ? (n & (tile - 1)) : n;
}

// Copies rows [0, rows) x columns [n0, n0 + cols) of both planes (leading
// dimension ld) into dst_hi / dst_lo (row-major, cols floats per row), with
// every thread of the block taking its share.  kVec: 16-byte copies (the
// caller guarantees 16-byte alignment of every chunk, so a chunk lies
// wholly inside or wholly outside [n0, n_end)); else 4-byte copies.
// Columns at or past n_end are zero-filled; rows >= rows are not copied.
template <bool kPinned, bool kVec, int kRows, int kCols, int kThreads>
__device__ __forceinline__ void stage_planes(float* dst_hi, float* dst_lo,
                                             const float* __restrict__ uh,
                                             const float* __restrict__ ul, int k0, int rows,
                                             int64_t n0, int64_t n_end, int64_t ld,
                                             int64_t tile) {
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kChunksPerRow = kCols / kPer;
  constexpr int kChunks = 2 * kRows * kChunksPerRow;
  static_assert(kChunks % kThreads == 0, "the chunks must split evenly over the threads");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int q = threadIdx.x + it * kThreads;
    const int plane = q / (kRows * kChunksPerRow);
    const int row = (q / kChunksPerRow) % kRows;
    const int ch = q % kChunksPerRow;
    if (row >= rows) continue;
    const int64_t n = n0 + (int64_t)ch * kPer;
    const bool in = n < n_end;
    const float* base = plane ? ul : uh;
    const float* src =
        in ? base + (size_t)(k0 + row) * (size_t)ld + (size_t)plane_col<kPinned>(n, tile) : base;
    float* dst = (plane ? dst_lo : dst_hi) + row * kCols + ch * kPer;
    if (kVec)
      cp_async16(dst, src, in ? 16 : 0);
    else
      cp_async4(dst, src, in ? 4 : 0);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kRowThreads, 2)
wsum_rows(const float* __restrict__ uh, const float* __restrict__ ul,
          const float* __restrict__ gh, const float* __restrict__ gl,
          const double* __restrict__ m, const double* __restrict__ r,
          int K, int64_t N, int64_t cols_per_split, double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, K - k0);
  const int split = blockIdx.y;
  const int64_t n0 = (int64_t)split * cols_per_split;
  const int64_t n1 = (n0 + cols_per_split < N) ? n0 + cols_per_split : N;
  const int ntiles = (n1 > n0) ? (int)((n1 - n0 + kRowTileCols - 1) / kRowTileCols) : 0;
  const int t = threadIdx.x;
  const int col = t % kRowTileCols;
  const int rg = t / kRowTileCols;  // the same for every lane of a warp

  double* tab = reinterpret_cast<double*>(smem + kRowStages * kRowStageBytes);
  exp_table_init(tab);  // visible after the first __syncthreads_or below
  double g[kRowsPerThread];
  double acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int kr = rg * kRowsPerThread + j;
    g[j] = (kr < rows) ? (double)gh[k0 + kr] + (double)gl[k0 + kr] : 0.0;
    acc[j] = 0.0;
  }

  // Stage i: both planes, then m and r of the tile's 128 columns.
  auto prefetch = [&](int i) {
    if (i < ntiles) {
      unsigned char* base = smem + (i % kRowStages) * kRowStageBytes;
      const int64_t tn0 = n0 + (int64_t)i * kRowTileCols;
      stage_planes<false, kVec, kRowsPerBlock, kRowTileCols, kRowThreads>(
          reinterpret_cast<float*>(base), reinterpret_cast<float*>(base + kRowPlaneBytes), uh,
          ul, k0, rows, tn0, n1, N, 0);
      if (t < kRowTileCols) {  // 64 chunks of m, then 64 of r
        const int which = t / (kRowTileCols / 2);
        const int ch = t % (kRowTileCols / 2);
        const int64_t n = tn0 + 2 * ch;
        const int64_t left = n1 - n;
        const int bytes = left >= 2 ? 16 : (left == 1 ? 8 : 0);
        const double* src = which ? r : m;
        cp_async16(base + 2 * kRowPlaneBytes + which * kRowTileCols * 8 + ch * 16,
                   bytes ? src + n : src, bytes);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

#pragma unroll
  for (int i = 0; i < kRowStages - 1; ++i) prefetch(i);
  for (int i = 0; i < ntiles; ++i) {
    prefetch(i + kRowStages - 1);  // into the slot tile i - 1 left
    cp_async_wait<kRowStages - 1>();
    const unsigned char* base = smem + (i % kRowStages) * kRowStageBytes;
    const float* sh = reinterpret_cast<const float*>(base);
    const float* sl = reinterpret_cast<const float*>(base + kRowPlaneBytes);
    const double* sm = reinterpret_cast<const double*>(base + 2 * kRowPlaneBytes);
    const double* sr = sm + kRowTileCols;
    // the tile is visible to every thread; skip it whole if no column counts
    if (__syncthreads_or(t < kRowTileCols && sr[t] != 0.0)) {
      const double rn = sr[col];
      if (rn != 0.0) {  // pad columns and zero weights add exactly 0
        const double mn = sm[col];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int kr = rg * kRowsPerThread + j;
          if (kr < rows) {
            const int idx = kr * kRowTileCols + col;
            const double a = g[j] - ((double)sh[idx] + (double)sl[idx]);
            acc[j] += exp_tab(a - mn, tab) * rn;
          }
        }
      }
    }
    __syncthreads();  // slot i % kRowStages is free for tile i + kRowStages
  }
  cp_async_wait<0>();
  __syncthreads();

  // rows of a row group: warp sums, then the group's 4 warps in order
  constexpr int kWarpsPerGroup = kRowTileCols / 32;
  double* red = reinterpret_cast<double*>(smem);  // [kRowsPerBlock][kWarpsPerGroup]
  const int lane = t & 31;
  const int wg = (t % kRowTileCols) / 32;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const double v = warp_sum(acc[j]);
    if (lane == 0) red[(rg * kRowsPerThread + j) * kWarpsPerGroup + wg] = v;
  }
  __syncthreads();
  if (t < rows) {
    double v = 0.0;
    for (int w = 0; w < kWarpsPerGroup; ++w) v += red[t * kWarpsPerGroup + w];
    partial[(size_t)split * (size_t)K + (size_t)(k0 + t)] = v;
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

// True when every 4-column chunk of rows with leading dimension ld starts
// on a 16-byte boundary, so the 16-byte copies apply.
inline bool planes_vec_ok(const float* uh, const float* ul, int64_t ld) {
  return ld % 4 == 0 && (reinterpret_cast<uintptr_t>(uh) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(ul) & 15) == 0;
}

template <bool kVec>
cudaError_t launch_rows_as(const float* uh, const float* ul, const float* gh, const float* gl,
                           const double* m, const double* r, int K, int64_t N,
                           int64_t cols_per_split, int n_split, double* partial,
                           cudaStream_t st) {
  auto kernel = wsum_rows<kVec>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((K + kRowsPerBlock - 1) / kRowsPerBlock, n_split);
  kernel<<<grid, kRowThreads, kRowSmemBytes, st>>>(uh, ul, gh, gl, m, r, K, N, cols_per_split,
                                                   partial);
  return cudaGetLastError();
}

// Launches wsum_rows on `st` over n_split column splits (each a whole
// number of column tiles) into partial ((n_split, K) float64, allocated by
// the caller).  m and r must be 16-byte aligned.
inline cudaError_t launch_rows(const float* uh, const float* ul, const float* gh,
                               const float* gl, const double* m, const double* r, int K,
                               int64_t N, int n_split, double* partial, cudaStream_t st) {
  if (K <= 0 || N <= 0 || n_split <= 0 || n_split > 65535) return cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(r)) & 15) != 0)
    return cudaErrorInvalidValue;
  const int64_t col_tiles = (N + kRowTileCols - 1) / kRowTileCols;
  const int64_t cols_per_split = (col_tiles + n_split - 1) / n_split * kRowTileCols;
  if (planes_vec_ok(uh, ul, N))
    return launch_rows_as<true>(uh, ul, gh, gl, m, r, K, N, cols_per_split, n_split, partial,
                                st);
  return launch_rows_as<false>(uh, ul, gh, gl, m, r, K, N, cols_per_split, n_split, partial, st);
}

// wsum_rows then wsum_finish on `st`; the (K,) float32 outputs allocated
// by the caller.
inline cudaError_t launch_rows_and_finish(const float* uh, const float* ul, const float* gh,
                                          const float* gl, const double* m, const double* r,
                                          int K, int64_t N, int n_split, double* partial,
                                          float* s_hi, float* s_lo, cudaStream_t st) {
  const cudaError_t e = launch_rows(uh, ul, gh, gl, m, r, K, N, n_split, partial, st);
  if (e != cudaSuccess) return e;
  wsum_finish<<<(K + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0, st>>>(
      partial, K, n_split, s_hi, s_lo);
  return cudaGetLastError();
}

}  // namespace
