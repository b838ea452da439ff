// K1, the kernel of every wsum_dd call that launches, shared by wsum.cu
// (production) and roofline.cu (the pinned probes K8b and K8c):
// S_k = sum_n T_kn r_n with T_kn = exp(a_kn - m_n), m_n = max_k
// (g_hi_k - u_hi_kn) in float32, s_n = sum_k T_kn and r_n = c_n / s_n (0 on
// a pad column, m_n < -1e8), from one read of both f32 planes and one f64
// exp per element.
//
// Its kLognum instantiation is K5 lognum_fused_dd (lognum.cu, which holds
// the identity and the threshold): the same stream with the column weight
// r_n = exp(m_n - ld_n), ld_n = log s_n + m_n rounded to its (hi, lo)
// float32 pair (lognum_column_weight), in place of c_n / s_n, so the
// partials are A_k = sum_n T_kn r_n and lognum.cu's finish forms s_k.  A
// row with |g_k + m_k| > kLognumDirectShift (lognum_direct_row, decided
// once per launch, a flag per row in shared memory) takes the direct
// form: in a block that has one, after T_kn entered s_n the row's T
// register takes exp((-m_k - u_kn) - m_n), so r_n completes K7's term.
// With kLognum false (K1) every K5 step compiles away.
//
// What bounds it on the H100: one read is 8 B/element (8.2 GB at the
// 1024 x 999424 flagship, 2.44 ms at 3.35 TB/s), but this kernel is held
// by its per-tile instruction stream, not by HBM: pinned to one
// L2-resident tile (roofline.cu, K8b) it reaches only ~1.8e11 elements/s,
// ~5.6 ms of the flagship's 1.02e9 elements, and it streams at ~6.5 ms.
// Per 8192-element block tile it pays two cluster barriers with their
// distributed-shared-memory reads, three block barriers, two 16-warp
// reductions and one f64 division per column, on one 16-warp block per
// SM at the 128-register cap (T and the row sums live in registers).
// Larger clusters pay more: each column's maxima and sums are read from
// every block of the cluster, and fewer clusters fit the GPCs.
//
// Design (the TPU kernel keeps a (K, tile) block on chip between its two
// reductions; one SM's 227 KB cannot hold 1024 rows of a useful tile, so a
// thread-block cluster shares the rows):
//   * A cluster of C = ceil(K / 512) blocks takes column tiles of
//     kFusedCols = 16 columns, tiles q, q + n_clusters, ... for cluster q,
//     so the resident clusters read neighbouring tiles together and each
//     row is fetched as one contiguous span at a time.  Block `rank` holds
//     rows [rank * ceil(K / C), ...) of each tile, at most 512 rows x 16
//     columns x 8 B = 64 KB per stage, in a ring of kFusedStages = 3 stages
//     filled by cp.async (16-byte copies).  512 rows per block keep the
//     flagship's clusters at 2 blocks, which fill all 132 SMs where
//     clusters of 4 fit on only 120.  C is at most 16, the H100's largest
//     (non-portable) cluster, so K1 holds K <= 8192: every K wsum_dd sends
//     it (up to wsum._SPLIT_ROUTE_K = 4096) and the 8192-state slice that
//     checks the many-state route against K1.  The clusters are
//     persistent: as many as are resident at once (the launcher asks the
//     occupancy API), at most one per column tile, each writing one (K,)
//     row of partial sums at the end.
//   * 512 threads: lane l of warp w owns column l % 16 and rows
//     32 w + 2 j + l / 16 (j = 0..15), so a warp reads 32 consecutive words
//     of two adjacent rows (no bank conflicts).
//   * Per tile: (1) each block's f32 column maxima of g_hi - u_hi go to
//     shared memory; a cluster barrier; every thread reads the C blocks'
//     maxima through distributed shared memory (max is exact in any
//     order).  (2) T = exp(a - m) in f64 (exp_tab of wsum_rows.cuh), kept
//     in registers, and the column sums over the block to shared memory; a
//     cluster barrier; every thread sums the C blocks' values in rank order
//     (the same bits in every block) and forms r_n.  (3) acc_k += T_kn r_n
//     in f64 registers that persist over the cluster's tiles.  No online
//     rescale and no data-dependent branch per element.
//   * The barriers are split (arrive, then wait) and work fills the gap:
//     tile i - 1's accumulation hides barrier (1) of tile i, and the next
//     tile's copies and column maxima hide barrier (2).  The maxima and
//     sums are double-buffered by tile parity, which the barrier order
//     makes safe.
//   * Rows past K are skipped; columns past N get T = 0 and r = 0.  Partial
//     sums go to partial[cluster, k]; wsum_finish (wsum_rows.cuh) adds them
//     in a fixed order.  No atomics: the same bits on every run.
//
// kPinned = true is the roofline probe: virtual column n reads column
// n & (tile - 1) of one (K, tile) pair.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wsum_rows.cuh"

namespace {

constexpr int kFusedThreads = 512;
constexpr int kFusedWarps = kFusedThreads / 32;                    // 16
constexpr int kFusedRowsPerThread = 16;
constexpr int kFusedCols = 16;
constexpr int kFusedLaneGroups = 32 / kFusedCols;  // rows a warp reads at once
constexpr int kFusedRows = kFusedThreads / kFusedCols * kFusedRowsPerThread;  // 512
constexpr int kFusedStages = 3;
constexpr int kFusedMaxCluster = 16;  // above 8 a non-portable cluster size
constexpr int kFusedPlaneBytes = kFusedRows * kFusedCols * 4;   // 32 KB
constexpr int kFusedStageBytes = 2 * kFusedPlaneBytes;          // 64 KB
// ring, exp table, g (f64, f32), the per-warp column maxima and sums, and
// the double-buffered per-block column maxima and sums read by the cluster
constexpr int kFusedSmemBytes = kFusedStages * kFusedStageBytes + kExpTableBytes +
                                kFusedRows * 8 + kFusedRows * 4 +
                                kFusedWarps * kFusedCols * 4 + kFusedWarps * kFusedCols * 8 +
                                2 * kFusedCols * 4 + 2 * kFusedCols * 8;  // 206,720
constexpr float kFusedPadShift = -1.0e8f;
// K5's block adds one direct-form flag per row
constexpr int kLognumSmemBytes = kFusedSmemBytes + kFusedRows;  // 207,232
// K5 takes a row k in the direct form when |g_k + m_k| exceeds this (the
// derivation is in lognum.cu's note)
constexpr double kLognumDirectShift = 64.0;

template <bool kLognum>
constexpr int fused_smem_bytes() {
  return kLognum ? kLognumSmemBytes : kFusedSmemBytes;
}

// K5: does row k take the direct form?  g = g_hi + g_lo and m_k in f64,
// the same expression in the kernel and in lognum.cu's finish, so both
// decide alike; NaN or inf in g + m_k takes the direct form.
__host__ __device__ __forceinline__ bool lognum_direct_row(double g, double mk) {
  return !(fabs(g + mk) <= kLognumDirectShift);
}

// K5's column weight r_n = exp(m_n - ld_n), with ld_n = log s_n + m_n
// rounded to the (hi, lo) float32 pair that K6 writes and K7 reads.
__device__ __forceinline__ double lognum_column_weight(double sn, double md,
                                                       const double* __restrict__ tab) {
  const double ld = log(sn) + md;
  const float hi = (float)ld;
  const float lo = (float)(ld - (double)hi);
  return exp_tab(md - ((double)hi + (double)lo), tab);
}

// .aligned: every thread of the warp executes the barrier together.
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <bool kPinned, bool kVec, bool kLognum>
__global__ void __launch_bounds__(kFusedThreads, 1)
wsum_fused(const float* __restrict__ uh, const float* __restrict__ ul,
           const float* __restrict__ gh, const float* __restrict__ gl,
           const float* __restrict__ c, const float* __restrict__ mk, int K, int64_t N,
           int64_t tile, int C, int n_clusters, double* __restrict__ partial) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem + kFusedStages * kFusedStageBytes;
  double* tab = reinterpret_cast<double*>(p);
  p += kExpTableBytes;
  double* gs = reinterpret_cast<double*>(p);
  p += kFusedRows * 8;
  float* ghs = reinterpret_cast<float*>(p);
  p += kFusedRows * 4;
  float* red_max = reinterpret_cast<float*>(p);  // [warp][col]
  p += kFusedWarps * kFusedCols * 4;
  double* red_sum = reinterpret_cast<double*>(p);  // [warp][col]
  p += kFusedWarps * kFusedCols * 8;
  float* lmax = reinterpret_cast<float*>(p);  // [parity][col], read by the cluster
  p += 2 * kFusedCols * 4;
  double* lsum = reinterpret_cast<double*>(p);  // [parity][col], read by the cluster
  p += 2 * kFusedCols * 8;
  unsigned char* direct = p;  // K5: the block's direct-form rows

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int q = (int)(blockIdx.x / (unsigned)C);
  const int rows_per_block = (K + C - 1) / C;
  const int k0 = rank * rows_per_block;
  const int rows = max(0, min(rows_per_block, K - k0));
  // tiles q, q + n_clusters, ...: the resident clusters read neighbouring
  // tiles together, so each row is read in one contiguous span at a time
  const int64_t col_tiles = (N + kFusedCols - 1) / kFusedCols;
  const int ntiles = (int)((col_tiles - q + n_clusters - 1) / n_clusters);
  const int64_t ld = kPinned ? tile : N;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int col = lane % kFusedCols;
  // row of j: row0 + kFusedLaneGroups j
  const int row0 = w * kFusedLaneGroups * kFusedRowsPerThread + lane / kFusedCols;

  auto slot = [&](int i) { return smem + (i % kFusedStages) * kFusedStageBytes; };
  auto prefetch = [&](int i) {
    if (i < ntiles) {
      unsigned char* base = slot(i);
      stage_planes<kPinned, kVec, kFusedRows, kFusedCols, kFusedThreads>(
          reinterpret_cast<float*>(base), reinterpret_cast<float*>(base + kFusedPlaneBytes), uh,
          ul, k0, rows, (q + (int64_t)i * n_clusters) * kFusedCols, N, ld, tile);
    }
    cp_async_commit();
  };
  // the block's f32 column maxima of tile i into lmax[i & 1]
  auto column_max = [&](int i) {
    const float* sh = reinterpret_cast<const float*>(slot(i));
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kFusedRowsPerThread; ++j) {
      const int kr = row0 + kFusedLaneGroups * j;
      if (kr < rows) mx = fmaxf(mx, ghs[kr] - sh[kr * kFusedCols + col]);
    }
#pragma unroll
    for (int off = kFusedCols; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane < kFusedCols) red_max[w * kFusedCols + col] = mx;
    __syncthreads();
    if (t < kFusedCols) {
      float v = red_max[t];
      for (int ww = 1; ww < kFusedWarps; ++ww) v = fmaxf(v, red_max[ww * kFusedCols + t]);
      lmax[(i & 1) * kFusedCols + t] = v;
    }
  };

#pragma unroll
  for (int i = 0; i < kFusedStages; ++i) prefetch(i);
  exp_table_init(tab);
  bool d = false;  // K5: row t takes the direct form
  if (t < kFusedRows) {
    const bool in = t < rows;
    gs[t] = in ? (double)gh[k0 + t] + (double)gl[k0 + t] : 0.0;
    ghs[t] = in ? gh[k0 + t] : 0.0f;
    if constexpr (kLognum) {
      d = in && lognum_direct_row(gs[t], (double)mk[k0 + t]);
      direct[t] = d;
    }
  }
  cp_async_wait<kFusedStages - 1>();
  bool any_direct = false;  // K5: a direct-form row in this block (block-uniform)
  if constexpr (kLognum) {
    any_direct = __syncthreads_or(d);
  } else {
    __syncthreads();
  }
  column_max(0);
  cluster_arrive();

  double T[kFusedRowsPerThread];
  double acc[kFusedRowsPerThread];
#pragma unroll
  for (int j = 0; j < kFusedRowsPerThread; ++j) T[j] = acc[j] = 0.0;
  double r_prev = 0.0;

  for (int i = 0; i < ntiles; ++i) {
    const int par = i & 1;
    if (r_prev != 0.0) {  // tile i - 1's share, while the cluster meets
#pragma unroll
      for (int j = 0; j < kFusedRowsPerThread; ++j) acc[j] += T[j] * r_prev;
    }
    cluster_wait();  // every block's maxima of tile i are visible

    float mf = -INFINITY;
    for (int b = 0; b < C; ++b)
      mf = fmaxf(mf, cluster.map_shared_rank(lmax, b)[par * kFusedCols + col]);
    const int64_t n = (q + (int64_t)i * n_clusters) * kFusedCols + col;
    const bool in = n < N;  // a column past N has mf = -inf: T = exp(-inf) = 0
    const double md = in ? (double)mf : INFINITY;
    const float* sh = reinterpret_cast<const float*>(slot(i));
    const float* sl = reinterpret_cast<const float*>(slot(i) + kFusedPlaneBytes);
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < kFusedRowsPerThread; ++j) {
      const int kr = row0 + kFusedLaneGroups * j;
      if (kr < rows) {
        const int idx = kr * kFusedCols + col;
        T[j] = exp_tab((gs[kr] - ((double)sh[idx] + (double)sl[idx])) - md, tab);
        s += T[j];
      } else {
        T[j] = 0.0;
      }
    }
    if constexpr (kLognum) {
      if (any_direct) {  // direct-form rows hold exp((-m_k - u_kn) - m_n); s has their T
#pragma unroll
        for (int j = 0; j < kFusedRowsPerThread; ++j) {
          const int kr = row0 + kFusedLaneGroups * j;
          if (kr < rows && direct[kr]) {
            const int idx = kr * kFusedCols + col;
            const double v = -(double)__ldg(mk + k0 + kr) - ((double)sh[idx] + (double)sl[idx]);
            T[j] = exp_tab(v - md, tab);
          }
        }
      }
    }
#pragma unroll
    for (int off = kFusedCols; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane < kFusedCols) red_sum[w * kFusedCols + col] = s;
    __syncthreads();  // red_sum full; slot i % kFusedStages no longer read
    if (t < kFusedCols) {
      double v = 0.0;
      for (int ww = 0; ww < kFusedWarps; ++ww) v += red_sum[ww * kFusedCols + t];
      lsum[par * kFusedCols + t] = v;
    }
    cluster_arrive();

    prefetch(i + kFusedStages);  // into the slot tile i left
    if (i + 1 < ntiles) {  // the next tile's maxima while the cluster meets
      cp_async_wait<kFusedStages - 1>();
      __syncthreads();
      column_max(i + 1);
    }
    cluster_wait();  // every block's sums of tile i are visible

    double sn = 0.0;
    for (int b = 0; b < C; ++b) sn += cluster.map_shared_rank(lsum, b)[par * kFusedCols + col];
    double rn = 0.0;
    if (in && !(mf < kFusedPadShift)) {  // the contract's pad rule
      if constexpr (kLognum) {
        rn = lognum_column_weight(sn, md, tab);
      } else {
        rn = 1.0 / sn;
        if (c != nullptr) rn *= (double)c[n];
      }
    }
    r_prev = rn;
    if (i + 1 < ntiles) cluster_arrive();
  }
  if (r_prev != 0.0) {
#pragma unroll
    for (int j = 0; j < kFusedRowsPerThread; ++j) acc[j] += T[j] * r_prev;
  }
  cp_async_wait<0>();
  // no block leaves while another may still read its shared memory
  cluster_arrive();
  cluster_wait();

  // each row's sum over its 16 columns (lanes of one half-warp)
#pragma unroll
  for (int j = 0; j < kFusedRowsPerThread; ++j) {
    double v = acc[j];
#pragma unroll
    for (int off = kFusedCols / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int kr = row0 + kFusedLaneGroups * j;
    if (col == 0 && kr < rows) partial[(size_t)q * (size_t)K + (size_t)(k0 + kr)] = v;
  }
}

// Blocks per cluster for K states; 0 when K exceeds the fused form.
inline int fused_cluster_size(int K) {
  const int C = (K + kFusedRows - 1) / kFusedRows;
  return (K > 0 && C <= kFusedMaxCluster) ? C : 0;
}

template <bool kPinned, bool kVec, bool kLognum>
cudaError_t fused_config(int C, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  auto* kernel = wsum_fused<kPinned, kVec, kLognum>;
  constexpr int smem = fused_smem_bytes<kLognum>();
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C);
  cfg->blockDim = dim3(kFusedThreads);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The clusters of C blocks the current card holds at once (0 on error).
// One block of either instantiation fills an SM (512 threads at the
// 128-register cap, over 200 KB of shared memory), so K1's answer is K5's.
inline int fused_max_clusters(int C) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (C <= 0 || fused_config<false, true, false>(C, &cfg, &attr) != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, wsum_fused<false, true, false>, &cfg) != cudaSuccess)
    return 0;
  return n;
}

template <bool kPinned, bool kVec, bool kLognum>
cudaError_t launch_fused_as(const float* uh, const float* ul, const float* gh, const float* gl,
                            const float* c, const float* mk, int K, int64_t N, int64_t tile,
                            int C, int n_clusters, double* partial, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = fused_config<kPinned, kVec, kLognum>(C, &cfg, &attr);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3((unsigned)(C * n_clusters));
  cfg.stream = st;
  e = cudaLaunchKernelEx(&cfg, wsum_fused<kPinned, kVec, kLognum>, uh, ul, gh, gl, c, mk, K, N,
                         tile, C, n_clusters, partial);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The fused kernel on `st` over min(max_clusters, column tiles) persistent
// clusters, their count in *n_clusters: K1 (c may be null, mk null) or K5
// (kLognum, c null, mk the row shifts).  partial ((max_clusters, K)
// float64) is allocated by the caller; `tile` is read only by the pinned
// probe.
template <bool kPinned, bool kLognum>
cudaError_t launch_fused(const float* uh, const float* ul, const float* gh, const float* gl,
                         const float* c, const float* mk, int K, int64_t N, int max_clusters,
                         double* partial, cudaStream_t st, int64_t tile, int* n_clusters) {
  const int C = fused_cluster_size(K);
  const int64_t col_tiles = (N + kFusedCols - 1) / kFusedCols;
  if (C == 0 || N <= 0 || max_clusters <= 0) return cudaErrorInvalidValue;
  *n_clusters = (int)(col_tiles < max_clusters ? col_tiles : max_clusters);
  return planes_vec_ok(uh, ul, kPinned ? tile : N)
             ? launch_fused_as<kPinned, true, kLognum>(uh, ul, gh, gl, c, mk, K, N, tile, C,
                                                       *n_clusters, partial, st)
             : launch_fused_as<kPinned, false, kLognum>(uh, ul, gh, gl, c, mk, K, N, tile, C,
                                                        *n_clusters, partial, st);
}

// K1 then wsum_finish on `st`; the (K,) float32 outputs allocated by the
// caller.
template <bool kPinned = false>
cudaError_t launch_fused_and_finish(const float* uh, const float* ul, const float* gh,
                                    const float* gl, const float* c, int K, int64_t N,
                                    int max_clusters, double* partial, float* s_hi, float* s_lo,
                                    cudaStream_t st, int64_t tile = 0) {
  int n_clusters = 0;
  const cudaError_t e = launch_fused<kPinned, false>(uh, ul, gh, gl, c, nullptr, K, N,
                                                     max_clusters, partial, st, tile, &n_clusters);
  if (e != cudaSuccess) return e;
  wsum_finish<<<(K + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0, st>>>(
      partial, K, n_clusters, s_hi, s_lo);
  return cudaGetLastError();
}

}  // namespace
