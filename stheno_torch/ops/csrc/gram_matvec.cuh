// The fused Gram x V kernel (K3) and its launcher, templated on the
// element type: gram_matvec.cu instantiates float, gram_matvec_f64.cu
// double, so that nvcc builds the two at once; the tensor-core kernel of
// gram_matvec_mma.cu shares the column-split reduction. See
// gram_matvec.cu for what the kernel computes and how.

#pragma once

#include <cuda_runtime.h>

#include <stddef.h>

#include "gram_kind.cuh"

namespace {

using namespace stheno;

constexpr int kThreads = 128;
constexpr int kTN = 64;  // columns staged per pass

// Rows per thread: as many as keep R * PC accumulators within 64 32-bit
// registers, between 1 and 4. ops/gram_matvec.py:_rows_per_thread repeats
// this rule to size the column split.
template <typename T, int PC>
__host__ __device__ constexpr int rows_per_thread() {
  return 256 / (PC * (int)sizeof(T)) < 1 ? 1
         : 256 / (PC * (int)sizeof(T)) > 4 ? 4
                                           : 256 / (PC * (int)sizeof(T));
}

// D > 0: the depth is D, x rows are held in registers and y in shared
// memory. D == 0: any depth d, read from global memory per entry (the
// slow general path; the iterative path has d = 1).
template <int KIND, int D, int PC, typename T>
__global__ void __launch_bounds__(kThreads)
gmv_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ v,
           T* __restrict__ dst, int n, int m, int d, int p, int span, T alpha) {
  constexpr int R = rows_per_thread<T, PC>();
  constexpr int TM = kThreads * R;
  constexpr int DS = D > 0 ? D : 1;
  __shared__ __align__(16) T ys[kTN * DS];
  __shared__ __align__(16) T yn[kTN];
  __shared__ __align__(16) T vs[kTN * PC];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * PC;
  const int col_begin = blockIdx.z * span;
  const int col_end = min(m, col_begin + span);

  int rows[R];
  T xr[R][DS], xn[R], acc[R][PC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rows[r] = blockIdx.x * TM + r * kThreads + tid;
    const bool live = rows[r] < n;
    xn[r] = T(0);
    if (D > 0) {
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        xr[r][k] = live ? x[(size_t)rows[r] * D + k] : T(0);
        xn[r] = fma(xr[r][k], xr[r][k], xn[r]);
      }
    } else if (live) {
      for (int k = 0; k < d; ++k) {
        const T xv = x[(size_t)rows[r] * d + k];
        xn[r] = fma(xv, xv, xn[r]);
      }
    }
#pragma unroll
    for (int c = 0; c < PC; ++c) acc[r][c] = T(0);
  }

  for (int j0 = col_begin; j0 < col_end; j0 += kTN) {
    __syncthreads();  // the previous pass has finished reading ys, yn, vs
    if (D > 0) {
      for (int e = tid; e < kTN * D; e += kThreads) {
        const int j = j0 + e / D;
        ys[e] = j < col_end ? y[(size_t)j * D + e % D] : T(0);
      }
    }
    for (int e = tid; e < kTN * PC; e += kThreads) {
      const int j = j0 + e / PC, c = c0 + e % PC;
      vs[e] = (j < col_end && c < p) ? v[(size_t)j * p + c] : T(0);
    }
    __syncthreads();
    if (tid < kTN) {
      T s = T(0);
      if (D > 0) {
#pragma unroll
        for (int k = 0; k < DS; ++k) s = fma(ys[tid * DS + k], ys[tid * DS + k], s);
      } else if (j0 + tid < col_end) {
        for (int k = 0; k < d; ++k) {
          const T yv = y[(size_t)(j0 + tid) * d + k];
          s = fma(yv, yv, s);
        }
      }
      yn[tid] = s;
    }
    __syncthreads();

    // Two-level sum: the pass's kTN products are summed from zero, then
    // added to the running total, so no float32 accumulator takes more
    // than kTN + m / kTN additions in a row (a single running sum over a
    // column range of 10^5 columns drifts by ~eps per addition).
    T part[R][PC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < PC; ++c) part[r][c] = T(0);
#pragma unroll 2
    for (int j = 0; j < kTN; ++j) {
      const T ynj = yn[j];
      T g[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T inner = T(0);
        if (D > 0) {
#pragma unroll
          for (int k = 0; k < DS; ++k) inner = fma(xr[r][k], ys[j * DS + k], inner);
        } else if (rows[r] < n && j0 + j < col_end) {
          for (int k = 0; k < d; ++k)
            inner = fma(x[(size_t)rows[r] * d + k], y[(size_t)(j0 + j) * d + k], inner);
        }
        g[r] = epilogue<KIND, T>(xn[r] + ynj - T(2) * inner, inner, alpha);
      }
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const T vc = vs[j * PC + c];
#pragma unroll
        for (int r = 0; r < R; ++r) part[r][c] = fma(g[r], vc, part[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[r][c] += part[r][c];
  }

  T* out = dst + (size_t)blockIdx.z * n * p;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (rows[r] >= n) continue;
#pragma unroll
    for (int c = 0; c < PC; ++c)
      if (c0 + c < p) out[(size_t)rows[r] * p + c0 + c] = acc[r][c];
  }
}

// out[i] = sum over s of part[s][i], s in order: the column splits'
// partial sums, added the same way on every call.
template <typename T>
__global__ void gmv_reduce(const T* __restrict__ part, T* __restrict__ out, size_t count,
                           int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    T s = part[i];
    for (int k = 1; k < splits; ++k) s += part[(size_t)k * count + i];
    out[i] = s;
  }
}

template <int KIND, int D, int PC, typename T>
cudaError_t launch_main(const T* x, const T* y, const T* v, T* dst, int n, int m, int d,
                        int p, int span, int splits, T alpha, cudaStream_t s) {
  constexpr int TM = kThreads * rows_per_thread<T, PC>();
  const dim3 grid((n + TM - 1) / TM, (p + PC - 1) / PC, splits);
  gmv_kernel<KIND, D, PC, T><<<grid, kThreads, 0, s>>>(x, y, v, dst, n, m, d, p, span, alpha);
  return cudaGetLastError();
}

template <int KIND, int D, typename T>
cudaError_t by_width(int pc, const T* x, const T* y, const T* v, T* dst, int n, int m, int d,
                     int p, int span, int splits, T alpha, cudaStream_t s) {
  switch (pc) {
    case 1: return launch_main<KIND, D, 1, T>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 4: return launch_main<KIND, D, 4, T>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 8: return launch_main<KIND, D, 8, T>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 16: return launch_main<KIND, D, 16, T>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 32: return launch_main<KIND, D, 32, T>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND, typename T>
cudaError_t by_depth(int pc, const T* x, const T* y, const T* v, T* dst, int n, int m, int d,
                     int p, int span, int splits, T alpha, cudaStream_t s) {
  if (d == 1) return by_width<KIND, 1, T>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s);
  return by_width<KIND, 0, T>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s);
}

template <typename T>
cudaError_t launch(int kind, int pc, const T* x, const T* y, const T* v, T* out, T* work,
                   int n, int m, int d, int p, int span, int splits, T alpha, cudaStream_t s) {
  T* dst = splits > 1 ? work : out;
  cudaError_t err;
  switch (kind) {
    case kEq: err = by_depth<kEq, T>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case kRq: err = by_depth<kRq, T>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case kMatern12: err = by_depth<kMatern12, T>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case kMatern32: err = by_depth<kMatern32, T>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case kMatern52: err = by_depth<kMatern52, T>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case kLinear: err = by_depth<kLinear, T>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = (size_t)n * p;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  gmv_reduce<T><<<blocks, 256, 0, s>>>(work, out, count, splits);
  return cudaGetLastError();
}

}  // namespace
