// What K1's forward (gram.cu), its backward (gram_bwd.cuh) and the
// backward's tangent kernel (gram_bwd_jvp.cuh) share: the three storage
// types and their arithmetic type, 16-byte vector loads and stores, the
// loading of one row's depth slice, asynchronous copies to shared memory,
// programmatic dependent launch, the warps' fixed-tree sums and the depth
// templates.
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

// The dtype codes of the C entry points (ops/gram.py:_DTYPE_CODES); the
// last is K1's float32-in, bfloat16-out tile (gram.cu).
enum DtypeCode { kF32 = 0, kF64 = 1, kBf16 = 2, kF32Bf16 = 3 };

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

__host__ __device__ constexpr int next_pow2(int v) {
  return v <= 1 ? 1 : 2 * next_pow2((v + 1) / 2);
}
__host__ __device__ constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

// The sum over the warp's 32 lanes of each of v[0, P) by recursive
// halving, a fixed tree: at offset o each lane keeps the half of its
// entries named by its bit o and adds its partner's, so P entries take P
// - 1 + 5 - log2(P) shuffles rather than 5 P. Returns the sum of entry
// halving_entry<P>(lane), the same in every lane that shares the lane's
// top log2(P) bits.
template <int P>
__device__ __forceinline__ int halving_entry(int lane) {
  int e = 0;
#pragma unroll
  for (int h = P / 2, o = 16; h >= 1; h /= 2, o /= 2) e += lane & o ? h : 0;
  return e;
}
template <int P, typename T>
__device__ __forceinline__ T halving_sum(T (&v)[P], int lane) {
  static_assert(P >= 1 && P <= 32 && (P & (P - 1)) == 0, "a power of two up to 32");
#pragma unroll
  for (int h = P / 2, o = 16; h >= 1; h /= 2, o /= 2) {
    const bool up = lane & o;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const T send = up ? v[k] : v[k + h];
      const T keep = up ? v[k + h] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
#pragma unroll
  for (int o = 16 >> log2i(P); o > 0; o /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return v[0];
}

// 16 (or 8) bytes from device to shared memory, asynchronously (cp.async
// through L2; the 8-byte form through L1), and the groups that order them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch (sm_90): a grid lets the next launch of
// its stream start early; that grid waits for this one's end (and its
// writes) before it reads them.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// The depth template of a depth d: 1, 2, 4 or 8 holds d <= D in
// registers in one pass; 0 is the generic loop over passes of 8.
inline int depth_template(int d) { return d <= 2 ? d : d <= 4 ? 4 : d <= 8 ? 8 : 0; }

}  // namespace
