// What K1's forward (gram.cu) and its backward (gram_bwd.cuh) share: the
// three storage types and their arithmetic type, 16-byte vector loads and
// stores, the loading of one row's depth slice, and the depth templates.
//
// Storage float32, float64 or bfloat16. bfloat16 is computed in float32
// and rounded once where it is stored, as the TPU kernel does
// (stheno_tpu/ops/gram.py:_gram_kernel: preferred_element_type float32).
// A thread owns 16 consecutive bytes of an output row: 4 float, 2 double
// or 8 bfloat16 (kVec), so a warp covers 512 contiguous bytes of a row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#include "gram_kind.cuh"

namespace {

using namespace stheno;

// The dtype codes of the C entry points (ops/gram.py:_DTYPE_CODES).
enum DtypeCode { kF32 = 0, kF64 = 1, kBf16 = 2 };

constexpr int kGramThreads = 256;
constexpr int kGramWarps = kGramThreads / 32;

template <typename S>
struct Arith {
  using T = S;
};
template <>
struct Arith<__nv_bfloat16> {
  using T = float;
};

// Elements of S in 16 bytes.
template <typename S>
constexpr int kVec = 16 / (int)sizeof(S);

__device__ __forceinline__ float to_arith(float v) { return v; }
__device__ __forceinline__ double to_arith(double v) { return v; }
__device__ __forceinline__ float to_arith(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S to_storage(typename Arith<S>::T v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_storage<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One 16-byte store (st.global.v4) and load (ld.global.nc.v4) at an
// address that is a multiple of 16.
template <typename S>
__device__ __forceinline__ void store16(S* dst, const S (&v)[kVec<S>]) {
  uint4 u;
  memcpy(&u, v, 16);
  *reinterpret_cast<uint4*>(dst) = u;
}
template <typename S>
__device__ __forceinline__ void load16(const S* src, S* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  memcpy(v, &u, 16);
}

// v[k] = p[k] for k < min(DC, left), 0 beyond: the slice [k0, k0 + DC) of
// a row of depth d, with p at its k0 and left = d - k0. Zeros change no
// inner product and no norm.
template <int DC, typename S, typename T>
__device__ __forceinline__ void load_depth(const S* p, int left, T (&v)[DC]) {
#pragma unroll
  for (int k = 0; k < DC; ++k) v[k] = k < left ? to_arith(__ldg(p + k)) : T(0);
}

// The depth template of a depth d: 1, 2, 4 or 8 holds d <= D in
// registers in one pass; 0 is the generic loop over passes of 8.
inline int depth_template(int d) { return d <= 2 ? d : d <= 4 ? 4 : d <= 8 ? 8 : 0; }

}  // namespace
