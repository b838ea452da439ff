// Theta's weight build for Hopper (sm_90a): one column chunk u (K, nc) of
// the reduced potentials in, the chunk's normalized weights and their
// aggregates out, in float or double (the work's dtype).
//
// Replaces no Pallas kernel: it fuses what XLA fuses on the TPU in the one
// jitted function pymbar_tpu/ops/mbar_core.py:476 (mbar_gram_normalization),
// which eager PyTorch ran as some twenty separate passes over the chunk.
// Contract, as ops/mbar_core.py's _logden_direct, _weights and the pad mask
// compute it, with d_kn = f_k - u_kn:
//   logden_n = log sum_{k in mask} N_k exp(d_kn - m_n) + m_n,
//              m_n = max_{k in mask} d_kn, taken as 0 when not finite; rows
//              outside the mask (null: every row) take no part in either
//   w_kn     = exp(d_kn - logden_n), or exactly 0 where u_kn >= 5e9 (the
//              sentinel of a pad column), for every row
//   rowsum_n = sum_k N_k w_kn      (the check sum_k N_k W_nk = 1)
//   colsum_k = sum_n w_kn          (the check sum_n W_nk = 1)
//
// What bounds it on the H100: bytes.  Reading u and writing w once is 16 B
// an element of double (a 512 MiB chunk: 0.32 ms at 3.35 TB/s); its two
// exps an element cost about a fifth of that on the FP64 pipes.
//
// Design: a block owns a tile of kTile = 64 adjacent columns, two a lane,
// so each row of a tile is one 16-byte load a lane and 512 contiguous bytes
// a warp (8-byte loads where the chunk's rows are not 16-byte aligned).
// The block's kWarps warps split the K rows (row k to warp k % kWarps), so
// even a chunk only 256 tiles wide (K = 4096) fills the SMs, and each warp
// keeps kUnroll rows' loads in flight.  The design reads u twice: 24 B an
// element.  Pass 1 is an online log-sum-exp, a running (max, sum) a column
// rescaled when the max rises; the warps merge their pairs in shared
// memory.  Pass 2 reads the tile's rows again (from HBM: a chunk is ten
// times the 50 MB L2), writes w once and accumulates in registers the row
// check's sums; each row's sum over the tile is a warp reduction, written
// as one partial per (tile, row).  fold_rows then sums the (tiles, K)
// partials over tiles in a fixed order, kFold at a time, so colsum is the
// same bits on every run.  No atomics.  The kernels run on the caller's
// stream and allocate nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;
constexpr int kUnroll = 4;
constexpr int kFold = 32;
constexpr int kFoldThreads = 256;
constexpr double kPadThreshold = 5.0e9;  // ops/mbar_core.py's _PAD_THRESHOLD

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// Columns c and c + 1 of a row; 0 beyond the chunk.  kVec: the row start
// is aligned to two elements, and c is even.
template <typename T, bool kVec>
__device__ __forceinline__ void load2(const T* __restrict__ row, int64_t c, int64_t nc, T& x,
                                      T& y) {
  if (kVec && c + 1 < nc) {
    const typename Pair<T>::type v = *reinterpret_cast<const typename Pair<T>::type*>(row + c);
    x = v.x;
    y = v.y;
  } else {
    x = c < nc ? row[c] : T(0);
    y = c + 1 < nc ? row[c + 1] : T(0);
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store2(T* __restrict__ row, int64_t c, int64_t nc, T x, T y) {
  if (kVec && c + 1 < nc) {
    typename Pair<T>::type v;
    v.x = x;
    v.y = y;
    *reinterpret_cast<typename Pair<T>::type*>(row + c) = v;
  } else {
    if (c < nc) row[c] = x;
    if (c + 1 < nc) row[c + 1] = y;
  }
}

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

// The shift a running max m stands for: m when finite, else 0.
template <typename T>
__device__ __forceinline__ T safe_shift(T m) {
  return (m > -T(INFINITY) && m < T(INFINITY)) ? m : T(0);
}

// Adds n exp(d - shift) to a running log-sum-exp (m, shift, s) that holds
// s = sum n_j exp(d_j - shift), shift = safe_shift(m), rescaling s when the
// max rises.  An empty sum (s == 0) is never rescaled: from m = -inf its
// factor could overflow, and 0 * inf is NaN.
template <typename T>
__device__ __forceinline__ void lse_add(T& m, T& shift, T& s, T d, T n) {
  if (d > m) {
    const T shift_new = safe_shift(d);
    if (s != T(0) && shift_new != shift) s *= exp_t(shift - shift_new);
    shift = shift_new;
    m = d;
  }
  s += n * exp_t(d - shift);
}

__device__ __forceinline__ bool row_in(const unsigned char* __restrict__ mask, int k) {
  return mask == nullptr || mask[k] != 0;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
gram_weights_kernel(const T* __restrict__ u, int64_t ldu, const T* __restrict__ f,
                    const T* __restrict__ nk, const unsigned char* __restrict__ mask, int K,
                    int64_t nc, T* __restrict__ w, T* __restrict__ logden,
                    T* __restrict__ rowsum, T* __restrict__ partial) {
  __shared__ T sh_m[kWarps][kTile];
  __shared__ T sh_s[kWarps][kTile];
  __shared__ T sh_ld[kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t c = (int64_t)blockIdx.x * kTile + 2 * lane;

  // Pass 1: each warp's running (max, sum) over its masked rows
  T m[2] = {-INFINITY, -INFINITY}, shift[2] = {T(0), T(0)}, s[2] = {T(0), T(0)};
  for (int k0 = warp; k0 < K; k0 += kWarps * kUnroll) {
    T x[kUnroll][2];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int k = k0 + r * kWarps;
      x[r][0] = x[r][1] = T(0);
      if (k < K && row_in(mask, k)) load2<T, kVec>(u + (int64_t)k * ldu, c, nc, x[r][0], x[r][1]);
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int k = k0 + r * kWarps;
      if (k < K && row_in(mask, k)) {
        const T fk = f[k], n = nk[k];
        lse_add(m[0], shift[0], s[0], fk - x[r][0], n);
        lse_add(m[1], shift[1], s[1], fk - x[r][1], n);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    sh_m[warp][2 * lane + j] = m[j];
    sh_s[warp][2 * lane + j] = s[j];
  }
  __syncthreads();
  // The warps' pairs merged in warp order: logden of the tile's columns
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 2 * lane + j;
      T mx = -INFINITY;
      for (int v = 0; v < kWarps; ++v) mx = sh_m[v][col] > mx ? sh_m[v][col] : mx;
      const T to = safe_shift(mx);
      T sum = T(0);
      for (int v = 0; v < kWarps; ++v) {
        const T sv = sh_s[v][col];
        if (sv != T(0)) sum += sv * exp_t(safe_shift(sh_m[v][col]) - to);
      }
      const T ld = log_t(sum) + to;
      sh_ld[col] = ld;
      if (c + j < nc) logden[c + j] = ld;
    }
  }
  __syncthreads();

  // Pass 2: the weights, written once; the row check's sums in registers;
  // each row's sum over the tile as one partial
  const T ld0 = sh_ld[2 * lane], ld1 = sh_ld[2 * lane + 1];
  const T pad = T(kPadThreshold);
  const bool in0 = c < nc, in1 = c + 1 < nc;
  T rs[2] = {T(0), T(0)};
  for (int k0 = warp; k0 < K; k0 += kWarps * kUnroll) {
    T x[kUnroll][2];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int k = k0 + r * kWarps;
      x[r][0] = x[r][1] = T(0);
      if (k < K) load2<T, kVec>(u + (int64_t)k * ldu, c, nc, x[r][0], x[r][1]);
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int k = k0 + r * kWarps;
      if (k >= K) break;
      const T fk = f[k], n = nk[k];
      const T w0 = (!in0 || x[r][0] >= pad) ? T(0) : exp_t((fk - x[r][0]) - ld0);
      const T w1 = (!in1 || x[r][1] >= pad) ? T(0) : exp_t((fk - x[r][1]) - ld1);
      store2<T, kVec>(w + (int64_t)k * nc, c, nc, w0, w1);
      rs[0] += n * w0;
      rs[1] += n * w1;
      T cs = w0 + w1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) cs += __shfl_xor_sync(0xffffffffu, cs, off);
      if (lane == 0) partial[(int64_t)blockIdx.x * K + k] = cs;
    }
  }
  // sh_m is free again: warp 0 read it before the second barrier
#pragma unroll
  for (int j = 0; j < 2; ++j) sh_m[warp][2 * lane + j] = rs[j];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      T t = T(0);
      for (int v = 0; v < kWarps; ++v) t += sh_m[v][2 * lane + j];
      if (c + j < nc) rowsum[c + j] = t;
    }
  }
}

// out[r K + k] = sum of in[t K + k] over t in [r kFold, min(rows, (r + 1) kFold)),
// in order of t.
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
fold_rows(const T* __restrict__ in, int64_t rows, int K, T* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kFoldThreads + threadIdx.x;
  const int64_t R = (rows + kFold - 1) / kFold;
  if (i >= R * K) return;
  const int64_t r = i / K;
  const int64_t k = i - r * K;
  const int64_t t1 = (r + 1) * kFold < rows ? (r + 1) * kFold : rows;
  T acc = T(0);
#pragma unroll 8
  for (int64_t t = r * kFold; t < t1; ++t) acc += in[t * K + k];
  out[i] = acc;
}

template <typename T>
cudaError_t launch(const T* u, int64_t ldu, const T* f, const T* nk, const unsigned char* mask,
                   int K, int64_t nc, T* w, T* logden, T* rowsum, T* partial, T* scratch,
                   T* colsum, cudaStream_t stream) {
  if (K <= 0 || nc <= 0) return cudaErrorInvalidValue;
  const int64_t tiles = (nc + kTile - 1) / kTile;
  const uintptr_t align = 2 * sizeof(T);
  const bool vec = (uintptr_t)u % align == 0 && (uintptr_t)w % align == 0 && ldu % 2 == 0 &&
                   nc % 2 == 0;
  if (vec) {
    gram_weights_kernel<T, true><<<(unsigned)tiles, kThreads, 0, stream>>>(
        u, ldu, f, nk, mask, K, nc, w, logden, rowsum, partial);
  } else {
    gram_weights_kernel<T, false><<<(unsigned)tiles, kThreads, 0, stream>>>(
        u, ldu, f, nk, mask, K, nc, w, logden, rowsum, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // partial (tiles, K) -> colsum, through scratch and partial in turn
  const T* in = partial;
  T* bufs[2] = {scratch, partial};
  for (int64_t rows = tiles, b = 0;; b ^= 1) {
    const int64_t R = (rows + kFold - 1) / kFold;
    T* out = R == 1 ? colsum : bufs[b];
    fold_rows<T><<<(unsigned)((R * K + kFoldThreads - 1) / kFoldThreads), kFoldThreads, 0,
                   stream>>>(in, rows, K, out);
    err = cudaGetLastError();
    if (err != cudaSuccess || R == 1) return err;
    in = out;
    rows = R;
  }
}

}  // namespace

// rows[0], rows[1]: the rows (of K elements each) of the partial and
// scratch buffers that a chunk of nc columns needs, ceil(nc / kTile) and
// ceil(nc / (kTile kFold)).  This file alone owns the tile and fold widths.
extern "C" void gram_weights_buffer_rows(int64_t nc, int64_t* rows) {
  const int64_t tiles = (nc + kTile - 1) / kTile;
  rows[0] = tiles;
  rows[1] = (tiles + kFold - 1) / kFold;
}

// The launchers return cudaGetLastError() (cudaErrorInvalidValue for an
// empty chunk).  u: (K, nc) with row stride ldu, unit column stride; f, nk:
// (K,); mask: (K,) bytes, nonzero for the rows of the log-denominator, or
// null for every row.  The caller allocates w (K, nc) contiguous, logden,
// rowsum (nc,), colsum (K,), and partial and scratch of the rows that
// gram_weights_buffer_rows gives, times K.
extern "C" int gram_weights_launch_f64(const double* u, int64_t ldu, const double* f,
                                       const double* nk, const unsigned char* mask, int K,
                                       int64_t nc, double* w, double* logden, double* rowsum,
                                       double* partial, double* scratch, double* colsum,
                                       void* stream) {
  return (int)launch<double>(u, ldu, f, nk, mask, K, nc, w, logden, rowsum, partial, scratch,
                             colsum, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int gram_weights_launch_f32(const float* u, int64_t ldu, const float* f,
                                       const float* nk, const unsigned char* mask, int K,
                                       int64_t nc, float* w, float* logden, float* rowsum,
                                       float* partial, float* scratch, float* colsum,
                                       void* stream) {
  return (int)launch<float>(u, ldu, f, nk, mask, K, nc, w, logden, rowsum, partial, scratch,
                            colsum, reinterpret_cast<cudaStream_t>(stream));
}
