// K1's column pass, shared by wsum.cu (K1 wsum_dd) and roofline.cu (the
// pinned-tile probes K8b/K8c): one thread per column, threads across n so
// every row load is coalesced; an online max with a rescaled sum gives m_n
// and s_n with one exp per element; writes m_n and r_n = c_n / s_n (f64
// scratch), r_n = 0 on a pad column (max_k(g_hi_k - u_hi_kn) < -1e8: every
// row holds the +1e10 sentinel).
//
// kPinned = false is production: column n of (K, N) planes.  kPinned = true
// is the roofline probe: virtual column n reads column n & (tile - 1) of one
// resident (K, tile) pair (tile a power of two), so the same arithmetic runs
// with every plane read served from L2.  The production instantiation
// compiles the index expression K1 always had.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kColThreads = 256;

template <bool kPinned>
__global__ void __launch_bounds__(kColThreads)
wsum_columns(const float* __restrict__ uh, const float* __restrict__ ul,
             const float* __restrict__ gh, const float* __restrict__ gl,
             const float* __restrict__ c, int K, int64_t N, int64_t tile,
             double* __restrict__ m_out, double* __restrict__ r_out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int64_t col = kPinned ? (n & (tile - 1)) : n;
  const int64_t ld = kPinned ? tile : N;
  double m = -INFINITY;
  double s = 0.0;
  float m_hi = -INFINITY;  // the pad test uses the hi words, as on the TPU
  for (int k = 0; k < K; ++k) {
    const size_t idx = (size_t)k * (size_t)ld + (size_t)col;
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

}  // namespace
