// What K3's three kernels share: the pass width and the fixed-order sum
// of the column splits. gram_matvec.cu (float32, p <= 16, FFMA),
// gram_matvec_mma.cu (float32, p >= 17, wgmma 3xTF32) and
// gram_matvec_f64.cu (float64, mma.m16n8k16.f64) each include it.

#pragma once

#include <cuda_runtime.h>

#include <stddef.h>

#include "gram_kind.cuh"

namespace {

using namespace stheno;

constexpr int kTN = 64;  // columns staged per pass

// out[i] = sum over s of part[s][i], s in order: the column splits'
// partial sums, added the same way on every call.
template <typename T>
__global__ void gmv_reduce(const T* __restrict__ part, T* __restrict__ out, size_t count,
                           int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    // In order, sixteen loads in flight at a time.
    T s = part[i];
    int k = 1;
    for (; k + 16 <= splits; k += 16) {
      T v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = part[(size_t)(k + u) * count + i];
#pragma unroll
      for (int u = 0; u < 16; ++u) s += v[u];
    }
    for (; k < splits; ++k) s += part[(size_t)k * count + i];
    out[i] = s;
  }
}

// The second launch of a split sweep: `work` holds splits * count partial
// sums; gmv_reduce adds them into `out`.
template <typename T>
cudaError_t reduce_splits(const T* work, T* out, size_t count, int splits, cudaStream_t s) {
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  gmv_reduce<T><<<blocks, 256, 0, s>>>(work, out, count, splits);
  return cudaGetLastError();
}

}  // namespace
