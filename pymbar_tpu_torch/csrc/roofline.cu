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
// K8b/K8c: K1's own kernel (wsum_fused.cuh) in its kPinned instantiation,
// over a virtual N = tile x steps in which column n reads column
// n & (tile - 1) of one resident tile pair (4 MB at (1024, 512), clusters
// of 2 blocks; 2 MB at (4096, 128), clusters of 8), so every plane read
// hits the 50 MB L2: the card's form of the TPU's "HBM effectively free".
// The result is exact: S = steps x S(tile), up to the order of the f64
// sums, and at one step it is K1's call bit for bit.

#include "wsum_fused.cuh"

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

// K1 over the virtual N = tile x steps of one (K, tile) pair (tile a power
// of two); partial is (max_clusters, K) float64, as K1 takes it.
extern "C" int wsum_pinned_launch(const float* uh, const float* ul, const float* gh,
                                  const float* gl, int K, int64_t tile, int64_t steps,
                                  int max_clusters, double* partial, float* s_hi, float* s_lo,
                                  void* stream) {
  if (K <= 0 || tile <= 0 || (tile & (tile - 1)) != 0 || steps <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_fused_and_finish<true>(uh, ul, gh, gl, nullptr, K, tile * steps,
                                            max_clusters, partial, s_hi, s_lo,
                                            reinterpret_cast<cudaStream_t>(stream), tile);
}
