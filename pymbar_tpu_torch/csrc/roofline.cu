// The roofline probes for Hopper (sm_90a): the card's arithmetic peaks and
// K1's compute ceiling.
//
// Replace the TPU probes of bench.py: `measure_vpu_peak` (K8a, :223, a
// VMEM-resident x <- x*x + c chain), `measure_wsum_ceiling` (K8b, :273,
// `_wsum_kernel` with every grid step pinned to one (1024, 512) tile pair)
// and `measure_wsum_big_ceiling` (K8c, :336, `_wsum_big_kernel` pinned at
// (4096, 128)).
//
// K8a: fma_chain<T> runs x <- fma(x, x, c) and exp_chain runs x <- exp(-x)
// (settles near 0.567 and never underflows) on register-resident values.
// Each thread carries kChains independent chains, enough to hide the FMA
// latency, over a grid sized by the caller to fill every SM; each writes
// its final x, so nothing folds away.  Bound: operations (the FP32 / FP64
// pipes, or the FP64 instructions of one exp); the memory traffic is one
// read and one write per chain.
//
// K8b/K8c: K1's own kernels (wsum_columns.cuh, wsum_rows.cuh) in their
// kPinned instantiation run over a virtual N = tile x steps in which column
// n reads column n & (tile - 1) of one resident tile pair (4 MB at (1024,
// 512), 2 MB at (4096, 128)), so every plane read hits the 50 MB L2: the
// card's form of the TPU's "HBM effectively free".  The per-column m_n and
// r_n scratch streams as in production.  The result is exact:
// S = steps x S(tile), up to the order of the f64 sums.

#include "wsum_columns.cuh"
#include "wsum_rows.cuh"

namespace {

constexpr int kChainThreads = 256;
constexpr int kChains = 8;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// Element j of thread t of block b is x[b * kChainThreads * kChains +
// j * kChainThreads + t]: coalesced loads and stores.
template <typename T>
__global__ void __launch_bounds__(kChainThreads)
fma_chain(T* __restrict__ x, T c, int64_t steps, int64_t n) {
  const int64_t base = (int64_t)blockIdx.x * kChainThreads * kChains + threadIdx.x;
  T v[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    const int64_t i = base + (int64_t)j * kChainThreads;
    v[j] = (i < n) ? x[i] : T(0);
  }
#pragma unroll 4
  for (int64_t s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) v[j] = fma_t(v[j], v[j], c);
  }
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    const int64_t i = base + (int64_t)j * kChainThreads;
    if (i < n) x[i] = v[j];
  }
}

__global__ void __launch_bounds__(kChainThreads)
exp_chain(double* __restrict__ x, int64_t steps, int64_t n) {
  const int64_t base = (int64_t)blockIdx.x * kChainThreads * kChains + threadIdx.x;
  double v[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    const int64_t i = base + (int64_t)j * kChainThreads;
    v[j] = (i < n) ? x[i] : 0.0;
  }
  for (int64_t s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) v[j] = exp(-v[j]);
  }
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    const int64_t i = base + (int64_t)j * kChainThreads;
    if (i < n) x[i] = v[j];
  }
}

bool chain_blocks(int64_t n, int64_t steps, unsigned* blocks) {
  if (n <= 0 || steps < 0) return false;
  const int64_t b = (n + (int64_t)kChainThreads * kChains - 1) / ((int64_t)kChainThreads * kChains);
  if (b > 2147483647LL) return false;
  *blocks = (unsigned)b;
  return true;
}

}  // namespace

// Each launcher runs its kernels on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernels do not take).  The chain
// kernels update x ((n,) contiguous) in place.
extern "C" int fma_chain_f32_launch(float* x, float c, int64_t steps, int64_t n, void* stream) {
  unsigned blocks;
  if (!chain_blocks(n, steps, &blocks)) return (int)cudaErrorInvalidValue;
  fma_chain<float><<<blocks, kChainThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, c, steps, n);
  return (int)cudaGetLastError();
}

extern "C" int fma_chain_f64_launch(double* x, double c, int64_t steps, int64_t n, void* stream) {
  unsigned blocks;
  if (!chain_blocks(n, steps, &blocks)) return (int)cudaErrorInvalidValue;
  fma_chain<double><<<blocks, kChainThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, c, steps, n);
  return (int)cudaGetLastError();
}

extern "C" int exp_chain_launch(double* x, int64_t steps, int64_t n, void* stream) {
  unsigned blocks;
  if (!chain_blocks(n, steps, &blocks)) return (int)cudaErrorInvalidValue;
  exp_chain<<<blocks, kChainThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(x, steps, n);
  return (int)cudaGetLastError();
}

// K1's column pass, row pass and finish over the virtual N = tile x steps
// of one (K, tile) pair (tile a power of two).  The caller allocates m and
// r ((tile x steps,) float64), partial ((n_split, K) float64) and the (K,)
// float32 outputs.
extern "C" int wsum_pinned_launch(const float* uh, const float* ul, const float* gh,
                                  const float* gl, int K, int64_t tile, int64_t steps,
                                  int n_split, double* m, double* r, double* partial,
                                  float* s_hi, float* s_lo, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (K <= 0 || tile <= 0 || (tile & (tile - 1)) != 0 || steps <= 0 || n_split <= 0 ||
      n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t N = tile * steps;
  const int64_t col_blocks = (N + kColThreads - 1) / kColThreads;
  if (col_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  wsum_columns<true><<<(unsigned)col_blocks, kColThreads, 0, st>>>(uh, ul, gh, gl, nullptr, K, N,
                                                                    tile, m, r);
  launch_rows_and_finish<true>(uh, ul, gh, gl, m, r, K, N, n_split, partial, s_hi, s_lo, st,
                               tile);
  return (int)cudaGetLastError();
}
