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
//   1. wsum_columns (wsum_columns.cuh): one thread per column, threads
//      across n so every row load is coalesced; an online max with a
//      rescaled sum gives m_n and s_n with one exp per element; writes m_n
//      and r_n (f64 scratch).
//   2. wsum_rows (wsum_rows.cuh, shared with K4): grid (k tiles of 8 rows,
//      n splits); each thread walks its columns once for all rows of the
//      tile, accumulates T_kn r_n in f64 registers, and the block reduces
//      with warp shuffles into partial[split, k].
//   3. wsum_finish (wsum_rows.cuh): sums the partials over the splits in a
//      fixed order and splits S into hi/lo float32.
// Recomputing T in pass 2 costs one more read of the planes (8 B/element)
// where storing it would cost a write and a read (16 B/element in f64).
// One read with T kept on chip (TMA tiles) is later work.  The same two
// passes over one L2-resident tile are the roofline probes of roofline.cu.

#include "wsum_columns.cuh"
#include "wsum_rows.cuh"

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
  wsum_columns<false><<<(unsigned)col_blocks, kColThreads, 0, st>>>(uh, ul, gh, gl, c, K, N, 0,
                                                                     m, r);

  launch_rows_and_finish(uh, ul, gh, gl, m, r, K, N, n_split, partial, s_hi, s_lo, st);
  return (int)cudaGetLastError();
}
