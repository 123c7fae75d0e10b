// Fused pairwise-distance + Gram kernel (K1) for Hopper, sm_90a.
//
// Replaces the Pallas kernel stheno_tpu/ops/gram.py:_gram_kernel. It
// computes out[i, j] = g(||x_i - y_j||^2) with d2 = |x_i|^2 + |y_j|^2 -
// 2 x_i.y_j clamped at 0 (or the plain x_i.y_j for the linear kind), for
// row-major x (n, d), y (m, d) and out (n, m).
//
// What bounds it: the (n, m) output write. The contraction has depth d (2
// on the flagship path), so the work per output element is a few FMAs and
// one transcendental: at N = 2000 in float32 the 16 MB store is the whole
// cost (about 4.8 us at 3.35 TB/s). The design therefore keeps the inputs
// in shared memory, never materialises d2, and makes every store a
// coalesced 128-byte warp transaction: a warp owns 32 consecutive columns
// of a row. Ragged edges are masked; no padded copies are made. No tensor
// cores: the depth is tiny and TF32 would round the inputs.
//
// The inner product and the norms use the same FMA chain, so for x is y
// the diagonal d2 is exactly 0.

#include <cuda_runtime.h>

#include "gram_kind.cuh"

namespace {

using namespace stheno;

constexpr int kTM = 64;        // rows of out per block
constexpr int kTN = 128;       // cols of out per block
constexpr int kDK = 8;         // depth staged in shared memory per pass
constexpr int kThreadsX = 32;  // a warp spans 32 consecutive columns
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = kTM / kThreadsY;  // 8
constexpr int kColsPerThread = kTN / kThreadsX;  // 4

template <int KIND, typename T>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
gram_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
            int n, int m, int d, T alpha) {
  __shared__ T xs[kDK][kTM];  // depth-major, so a column of the tile is contiguous
  __shared__ T ys[kDK][kTN];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int row0 = blockIdx.y * kTM, col0 = blockIdx.x * kTN;

  T acc[kRowsPerThread][kColsPerThread];
  T xn[kRowsPerThread], yn[kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    xn[i] = T(0);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = T(0);
  }
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) yn[j] = T(0);

  for (int k0 = 0; k0 < d; k0 += kDK) {
    // Zero-filled beyond the ragged edges: zeros change no inner product
    // and no norm.
    for (int e = tid; e < kTM * kDK; e += kThreadsX * kThreadsY) {
      const int r = e / kDK, k = e % kDK;
      const int gr = row0 + r, gk = k0 + k;
      xs[k][r] = (gr < n && gk < d) ? x[(size_t)gr * d + gk] : T(0);
    }
    for (int e = tid; e < kTN * kDK; e += kThreadsX * kThreadsY) {
      const int c = e / kDK, k = e % kDK;
      const int gc = col0 + c, gk = k0 + k;
      ys[k][c] = (gc < m && gk < d) ? y[(size_t)gc * d + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDK; ++k) {
      T xv[kRowsPerThread], yv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        xv[i] = xs[k][ty + kThreadsY * i];
        xn[i] = fma(xv[i], xv[i], xn[i]);
      }
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        yv[j] = ys[k][tx + kThreadsX * j];
        yn[j] = fma(yv[j], yv[j], yn[j]);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          acc[i][j] = fma(xv[i], yv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = row0 + ty + kThreadsY * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = col0 + tx + kThreadsX * j;
      if (c >= m) continue;
      const T d2 = xn[i] + yn[j] - T(2) * acc[i][j];
      out[(size_t)r * m + c] = epilogue<KIND, T>(d2, acc[i][j], alpha);
    }
  }
}

template <typename T>
cudaError_t launch(int kind, const T* x, const T* y, T* out, int n, int m, int d,
                   T alpha, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((m + kTN - 1) / kTN, (n + kTM - 1) / kTM);
  switch (kind) {
    case kEq: gram_kernel<kEq, T><<<grid, block, 0, stream>>>(x, y, out, n, m, d, alpha); break;
    case kRq: gram_kernel<kRq, T><<<grid, block, 0, stream>>>(x, y, out, n, m, d, alpha); break;
    case kMatern12: gram_kernel<kMatern12, T><<<grid, block, 0, stream>>>(x, y, out, n, m, d, alpha); break;
    case kMatern32: gram_kernel<kMatern32, T><<<grid, block, 0, stream>>>(x, y, out, n, m, d, alpha); break;
    case kMatern52: gram_kernel<kMatern52, T><<<grid, block, 0, stream>>>(x, y, out, n, m, d, alpha); break;
    case kLinear: gram_kernel<kLinear, T><<<grid, block, 0, stream>>>(x, y, out, n, m, d, alpha); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream`. `kind` follows the Kind enum above; `is_double`
// selects float64 (else float32). Returns cudaGetLastError() after the
// launch; the caller raises if it is not 0.
extern "C" int stheno_gram(int kind, int is_double, const void* x, const void* y,
                           void* out, int n, int m, int d, double alpha, void* stream) {
  if (n <= 0 || m <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return (int)launch<double>(kind, static_cast<const double*>(x),
                               static_cast<const double*>(y), static_cast<double*>(out),
                               n, m, d, alpha, s);
  return (int)launch<float>(kind, static_cast<const float*>(x), static_cast<const float*>(y),
                            static_cast<float*>(out), n, m, d, (float)alpha, s);
}
