// wsum_dd for Hopper (sm_90a): S_k = sum_n c_n N_k W_nk from the (hi, lo)
// float32 planes of the preconditioned reduced potentials u_kn.
//
// Replaces the TPU kernel `_wsum_kernel` (pymbar_tpu/ops/pallas_kernels.py:584)
// and, up to 8192 states, also the role of `_wsum_big_kernel` (:476).
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
// One form, the single-read kernel of wsum_fused.cuh, as the TPU kernel does
// it: each column tile read once by a thread-block cluster that shares its K
// rows (up to 16 blocks of 512 rows, so K <= 8192), the shift m_n the
// float32 max of the hi words, one f64 exp per element kept in registers
// between the column sums and the row sums.  Its bound is one read of the
// planes (8 B/element, 2.44 ms at the 1024 x 999424 flagship); what holds it
// is its per-tile barriers and reductions (see wsum_fused.cuh).  It ends in
// wsum_finish: per-cluster partials summed in a fixed order, no atomics, the
// same bits on every run.

#include "wsum_fused.cuh"

// The launcher runs the kernels on `stream` and returns cudaGetLastError()
// (or the error of the launch API; cudaErrorInvalidValue for a shape it
// cannot take).  The caller allocates the (K,) float32 outputs and partial,
// (max_clusters, K) float64; c may be null.
extern "C" int wsum_fused_launch(const float* uh, const float* ul, const float* gh,
                                 const float* gl, const float* c, int K, int64_t N,
                                 int max_clusters, double* partial, float* s_hi, float* s_lo,
                                 void* stream) {
  return (int)launch_fused_and_finish(uh, ul, gh, gl, c, K, N, max_clusters, partial, s_hi,
                                      s_lo, reinterpret_cast<cudaStream_t>(stream));
}

// The clusters of the kernel for K states that the current card holds at
// once, in *out (0 when K exceeds the largest cluster).
extern "C" int wsum_fused_clusters(int K, int* out) {
  const int C = fused_cluster_size(K);
  *out = C ? fused_max_clusters(C) : 0;
  return (int)cudaGetLastError();
}
